"""Plain reference of the jamba family, and the check that holds the
program's search to it, keys, values and recurrent states included.

Plain PyTorch in float32 (TF32 off), following ``modeling_jamba.py``
(``JambaForCausalLM``, transformers 4.57): each layer is a pre-normed
mixer and a pre-normed FFN, each with its residual (RMSNorm, eps from the
configuration).  The mixer is

- attention (``JambaAttention``): grouped-query attention scaled by
  1/sqrt(head_dim), causal, with **no positional encoding**;
- Mamba-1 (``JambaMambaMixer.slow_forward``): in_proj to x and the gate
  z; a causal depthwise convolution over x (kernel ``mamba_d_conv``, with
  bias) and SiLU; x_proj to dt, B and C, each RMS-normalized with its own
  scale; dt = softplus(dt_proj(dt)); the selective scan h_t = exp(dt_t A)
  h_{t-1} + dt_t B_t x_t, y_t = C_t . h_t + D x_t, with A = -exp(A_log);
  y times SiLU(z); out_proj.

The FFN is a SwiGLU MLP, or on MoE layers ``JambaSparseMoeBlock``: the
router's softmax over all ``router_experts``, the top k **not
renormalized**, and every assignment kept (dropless).

Departures from the published model, each the configuration's: the MoE
layer holds the experts ``experts_held`` of the router's ids and adds
only their part of the result (expert parallelism's share on one of the
chips that divide the layer; what the absent experts would add is left
out, as in the program); the recurrent state is kept in float32 (the
program keeps its SSM state in float32 and its conv state, the last
``mamba_d_conv - 1`` inputs, in the activations' dtype); and the weights
are random.  ``transformers`` keeps ``mamba_d_conv`` inputs as its conv
state, the last of which never enters a later step's convolution; the
program and this reference keep the ``mamba_d_conv - 1`` that do.

The selective scan is this file's own chunked form: blocks of
``SCAN_BLOCK`` positions, each cut into chunks of ``SCAN_CHUNK``; every
chunk's local states from a zero start run in step over the chunks at
once, the chunks' start states are carried across in order, and each
position then adds its chunk's start state decayed to it.

It takes the weights and tokens the benchmark made and works out the
rest again: the trunk's keys, values, states and logits, and each
sampled node's over its own tokens from the trunk's.  It runs layer by
layer, each layer's weights made float32 only while it runs (an MoE
layer's one expert at a time), and beside the program's weights on the
card: the trunk's Mamba runs in pieces of ``PIECE`` positions carrying
its states, and a dense MLP over ``PIECE`` rows at a time.

With ``control`` the same pass runs a second time beside it in fp8 (e4m3,
weights scaled per tensor, every matmul's input per row): the precision
below the configuration's bfloat16.  Its readings, held to the limits in
the program's place, are what the limits must reject.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

ATTN_BLOCK = 256          # query rows per block of the trunk's attention
SCAN_BLOCK = 1024         # positions per block of the selective scan
SCAN_CHUNK = 32           # positions per chunk within a block
PIECE = 4096              # trunk positions a mamba or MLP call takes at once
FP8_MAX = 448.0           # largest finite float8_e4m3fn
F = torch.nn.functional


def _fq(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``t`` through float8 e4m3 and back, scaled per tensor (``dim``
    None) or per slice along ``dim``."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = (amax / FP8_MAX).clamp_min(1e-12)
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def period(cfg: Dict[str, Any]) -> List[tuple]:
    """(mixer, FFN) of each layer of one period, from the offsets."""
    pa, pe = cfg["attn_layer_period"], cfg["expert_layer_period"]
    n = pa * pe // math.gcd(pa, pe)
    return [("attn" if i % pa == cfg["attn_layer_offset"] else "mamba",
             "moe" if i % pe == cfg["expert_layer_offset"] else "mlp") for i in range(n)]


def scan(dt, xc, Bm, Cm, A, h0):
    """The selective scan of ``n`` sequences: dt, xc (n, S, di), B, C
    (n, S, ds), A (di, ds), start state h0 (n, di, ds).  Returns y (n, S,
    di) without the D skip, and the state after the last position.  A
    position whose dt is 0 leaves the state as it was."""
    n, S, di = xc.shape
    L = SCAN_CHUNK
    pad = -S % L
    if pad:
        dt, xc, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, xc, Bm, Cm))
    ys = []
    h = h0
    for b0 in range(0, S + pad, SCAN_BLOCK):
        sl = slice(b0, min(b0 + SCAN_BLOCK, S + pad))
        T = sl.stop - sl.start
        nc = T // L
        dA = torch.exp(dt[:, sl, :, None] * A).reshape(n, nc, L, di, -1)
        dBx = ((dt[:, sl] * xc[:, sl])[..., None] * Bm[:, sl, None, :]).reshape(n, nc, L, di, -1)
        C = Cm[:, sl].reshape(n, nc, L, 1, -1)
        y = torch.empty(n, nc, L, di, device=xc.device)
        local = torch.zeros_like(dA[:, :, 0])
        decay = torch.ones_like(local)
        for t in range(L):                         # every chunk from a zero start
            local = dA[:, :, t] * local + dBx[:, :, t]
            decay = dA[:, :, t] * decay
            y[:, :, t] = (local * C[:, :, t]).sum(-1)
        starts = []
        for c in range(nc):                        # carry across the chunks
            starts.append(h)
            h = decay[:, c] * h + local[:, c]
        start = torch.stack(starts, dim=1)
        decay = torch.ones_like(local)
        for t in range(L):                         # each position's share of its start
            decay = dA[:, :, t] * decay
            y[:, :, t] += (decay * start * C[:, :, t]).sum(-1)
        ys.append(y.reshape(n, T, di))
        del dA, dBx
    return torch.cat(ys, dim=1)[:, :S], h


class Plain:
    """One precision's pass: ``fp8`` fake-quantizes weights and matmul
    inputs, else everything is float32."""

    def __init__(self, cfg: Dict[str, Any], weights: Dict[str, Any], fp8: bool = False):
        self.cfg, self.w, self.fp8 = cfg, weights, fp8
        self.d = cfg["hidden_size"]
        self.H, self.KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.Hd = self.d // self.H
        self.G = self.H // self.KVH
        self.eps = float(cfg["rms_norm_eps"])
        self.period = period(cfg)
        self.held = tuple(cfg["experts_held"])

    # ------------------------------------------------------------ weights
    def _f(self, t: torch.Tensor, matrix: bool = True) -> torch.Tensor:
        t = t.float()
        return _fq(t, None) if (self.fp8 and matrix) else t

    def kinds(self, i: int):
        return self.period[i % len(self.period)]

    def layer(self, i: int) -> Dict[str, Any]:
        """Layer ``i``'s weights (an MoE layer's experts stay as stored)."""
        P = len(self.period)
        li, r = i % P, i // P
        mixer, ffn = self.period[li]
        s = self.w["stage0"]
        m, g = s[f"l{li}_s0_{mixer}"], s[f"l{li}_s1_{ffn}"]
        b = m["body"]
        W: Dict[str, Any] = {"mixer": mixer, "ffn": ffn, "n1": m["norm"]["scale"][r].float(),
                             "n2": g["norm"]["scale"][r].float()}
        d, H, KVH, Hd = self.d, self.H, self.KVH, self.Hd
        if mixer == "attn":
            W.update(wq=self._f(b["wq"][r].reshape(d, H * Hd)),
                     wk=self._f(b["wk"][r].reshape(d, KVH * Hd)),
                     wv=self._f(b["wv"][r].reshape(d, KVH * Hd)),
                     wo=self._f(b["wo"][r].reshape(H * Hd, d)))
        else:
            W.update(w_in=self._f(b["w_in"][r]), conv_w=b["conv_w"][r].float(),
                     conv_b=b["conv_b"][r].float(), w_x=self._f(b["w_x_dbc"][r]),
                     w_dt=self._f(b["w_dt"][r]), dt_bias=b["dt_bias"][r].float(),
                     A=-torch.exp(b["A_log"][r].float()), D=b["D"][r].float(),
                     w_out=self._f(b["w_out"][r]),
                     dt_n=b["dt_norm"]["scale"][r].float(), b_n=b["b_norm"]["scale"][r].float(),
                     c_n=b["c_norm"]["scale"][r].float())
        fb = g["body"]
        if ffn == "moe":
            W.update(router=fb["router"][r].float(), experts=(fb["w_gate"][r], fb["w_up"][r],
                                                              fb["w_down"][r]))
        else:
            W.update(w_gate=self._f(fb["w_gate"][r]), w_up=self._f(fb["w_up"][r]),
                     w_down=self._f(fb["w_down"][r]))
        return W

    # ----------------------------------------------------------- pieces
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fq(x, -1) if self.fp8 else x) @ w

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * scale

    def qkv(self, W, x: torch.Tensor):
        h = self.rms(x, W["n1"])
        S = x.shape[0]
        return (self.mm(h, W["wq"]).reshape(S, self.H, self.Hd),
                self.mm(h, W["wk"]).reshape(S, self.KVH, self.Hd),
                self.mm(h, W["wv"]).reshape(S, self.KVH, self.Hd))

    def attend(self, q, k, v, q0: int) -> torch.Tensor:
        """Causal attention of queries at positions q0.. over keys 0..;
        returns (Sq, H * Hd)."""
        Sq, Sk = q.shape[0], k.shape[0]
        if Sq == 0:
            return q.new_zeros(0, self.H * self.Hd)
        kh = k.repeat_interleave(self.G, dim=1).transpose(0, 1)      # (H, Sk, Hd)
        vh = v.repeat_interleave(self.G, dim=1).transpose(0, 1)
        out = []
        for b in range(0, Sq, ATTN_BLOCK):
            qb = q[b: b + ATTN_BLOCK].transpose(0, 1) / math.sqrt(self.Hd)   # (H, nb, Hd)
            n = min(Sk, q0 + b + qb.shape[1])
            s = qb @ kh[:, :n].transpose(1, 2)                         # (H, nb, n)
            qpos = q0 + b + torch.arange(qb.shape[1], device=q.device)
            s = s.masked_fill(torch.arange(n, device=q.device)[None, :] > qpos[:, None],
                              float("-inf"))
            out.append((torch.softmax(s, dim=-1) @ vh[:, :n]).transpose(0, 1))
        return torch.cat(out).reshape(Sq, self.H * self.Hd)

    def mamba(self, W, x: torch.Tensor, lens: torch.Tensor, conv0: torch.Tensor,
              h0: torch.Tensor):
        """Mamba over ``n`` sequences ``x`` (n, S, d), sequence j's first
        ``lens[j]`` positions real (the rest padding), from conv states
        conv0 (n, dc-1, di) and SSM states h0 (n, di, ds).  Returns the
        mixer's output (n, S, d) and each sequence's states after its last
        real position."""
        n, S, _ = x.shape
        dc = W["conv_w"].shape[0]
        xz = self.mm(self.rms(x, W["n1"]), W["w_in"])
        xi, z = xz.chunk(2, dim=-1)                                    # (n, S, di)
        x_pad = torch.cat([conv0, xi], dim=1)                          # (n, S+dc-1, di)
        xc = sum(x_pad[:, i: i + S] * W["conv_w"][i] for i in range(dc)) + W["conv_b"]
        xc = F.silu(xc)
        dr = W["w_dt"].shape[0]
        ds = W["A"].shape[1]
        dt, Bm, Cm = torch.split(self.mm(xc, W["w_x"]), [dr, ds, ds], dim=-1)
        dt = self.mm(self.rms(dt, W["dt_n"]), W["w_dt"])
        Bm, Cm = self.rms(Bm, W["b_n"]), self.rms(Cm, W["c_n"])
        dt = F.softplus(dt + W["dt_bias"])
        real = torch.arange(S, device=x.device)[None, :] < lens[:, None]
        dt = dt * real[..., None]
        y, h = scan(dt, xc, Bm, Cm, W["A"], h0)
        y = (y + xc * W["D"]) * F.silu(z)
        idx = lens[:, None] + torch.arange(dc - 1, device=x.device)[None, :]   # last dc-1 inputs
        conv = x_pad.gather(1, idx[..., None].expand(-1, -1, x_pad.shape[2]))
        return self.mm(y, W["w_out"]), conv, h

    def ffn(self, W, h: torch.Tensor) -> torch.Tensor:
        if W["ffn"] == "mlp":
            return torch.cat([self.mm(F.silu(self.mm(b, W["w_gate"])) * self.mm(b, W["w_up"]),
                                      W["w_down"]) for b in h.split(PIECE)])
        return self.moe(W, h)

    def moe(self, W, h: torch.Tensor) -> torch.Tensor:
        """``JambaSparseMoeBlock`` over the held experts: the softmax over
        every router output, its top k as they are, each held expert over
        the tokens routed to it."""
        K = self.cfg["num_experts_per_tok"]
        probs = torch.softmax(h @ W["router"], dim=-1)
        gate, ids = torch.topk(probs, K, dim=-1)                      # (T, K)
        out = torch.zeros_like(h)
        lo, hi = self.held
        wg, wu, wd = W["experts"]
        for e in range(lo, hi):
            t_idx, k_idx = torch.nonzero(ids == e, as_tuple=True)
            if t_idx.numel() == 0:
                continue
            x = h[t_idx]
            y = F.silu(self.mm(x, self._f(wg[e - lo]))) * self.mm(x, self._f(wu[e - lo]))
            y = self.mm(y, self._f(wd[e - lo]))
            out.index_add_(0, t_idx, y * gate[t_idx, k_idx][:, None])
        return out

    def head(self, x: torch.Tensor) -> torch.Tensor:
        h = self.rms(x, self.w["final_norm"]["scale"].float())
        return self.mm(h, self._f(self.w["lm_head"]).T)


class Pass:
    """The hidden states of the trunk and of every node's tokens through
    one ``Plain``."""

    def __init__(self, plain: Plain, prompt: torch.Tensor, suffixes: List[torch.Tensor]):
        emb = plain.w["embed"]
        self.p = plain
        self.x = emb[prompt].float()
        self.xs = [emb[s].float() for s in suffixes]
        self.S = prompt.shape[0]

    def layer(self, W):
        """Advance every sequence by one layer.  Returns ("attn", the
        trunk's (k, v), each node's) or ("mamba", the trunk's (conv, ssm),
        each node's)."""
        p, S = self.p, self.S
        dev = self.x.device
        lens = [x.shape[0] for x in self.xs]
        if W["mixer"] == "attn":
            q, k, v = p.qkv(W, self.x)
            self.x = self.x + p.mm(p.attend(q, k, v, 0), W["wo"])
            node = []
            for i, xs in enumerate(self.xs):
                qi, ki, vi = p.qkv(W, xs)
                ctx = p.attend(qi, torch.cat([k, ki]), torch.cat([v, vi]), S)
                self.xs[i] = xs + p.mm(ctx, W["wo"])
                node.append((ki, vi))
            trunk = (k, v)
        else:
            di, ds = W["A"].shape
            dc = W["conv_w"].shape[0]
            conv, h = self.x.new_zeros(1, dc - 1, di), self.x.new_zeros(1, di, ds)
            outs = []
            for xp in self.x.split(PIECE):
                out, conv, h = p.mamba(W, xp[None], torch.tensor([xp.shape[0]], device=dev),
                                       conv, h)
                outs.append(out[0])
            self.x = self.x + torch.cat(outs)
            trunk = (conv[0], h[0])
            node = []
            if self.xs:
                n, Lm = len(self.xs), max(lens)
                xb = torch.stack([F.pad(x, (0, 0, 0, Lm - x.shape[0])) for x in self.xs])
                out, conv_n, h_n = p.mamba(W, xb, torch.tensor(lens, device=dev),
                                           conv.expand(n, -1, -1), h.expand(n, -1, -1))
                self.xs = [x + o[: x.shape[0]] for x, o in zip(self.xs, out)]
                node = list(zip(conv_n, h_n))
        self.x = self.x + p.ffn(W, p.rms(self.x, W["n2"]))
        if self.xs:
            cat = torch.cat(self.xs)
            moved = cat + p.ffn(W, p.rms(cat, W["n2"]))
            self.xs = list(moved.split(lens))
        return W["mixer"], trunk, node

    def logits(self):
        """The trunk's last position's logits (V,) and each node's (n, V)."""
        last = self.p.head(self.x[-1:])[0]
        return last, [self.p.head(x) for x in self.xs]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want) /
                 torch.linalg.vector_norm(want).clamp_min(1e-30))


def check(cfg: Dict[str, Any], weights: Dict[str, Any], prompt: List[int],
          outputs: Dict[str, Any], *, k_tokens: int, width: int, device,
          control: bool = False) -> Dict[str, Any]:
    """The numbers compared.

    ``outputs`` holds ``prompt_len``, the trunk's K/V (``trunk``: the
    attention layers in order) and recurrent states (``trunk_state``: per
    mamba tag, its ``conv`` (N, dc-1, di) and ``ssm`` (N, di, ds) over the
    periods), and ``nodes``: each with its ``tail``, ``seq_len``,
    ``depth`` and, for a node restored for the check, ``path``, ``kv``
    (the program's K/V of positions ``kv["lo"]`` on) and ``state``.

    ``logit_gap`` and ``kv_rel_err`` are those of the qwen3 reference's
    check (``bench/reference/qwen3.py``).  ``state_rel_err`` is the largest
    relative error (Frobenius), per mamba layer, of the program's SSM and
    conv states apart, over the trunk's and each restored node's, in the
    mamba layers whose input no MoE router has shaped (``state_layers``:
    Jamba's 0 and 1).  A sound program reads low there, while a zeroed
    state reads 1.  Past a router, a token whose bfloat16 router logits
    differ from float32's by a hair can take another expert, and every
    later layer's state for it moves by more than rounding; deeper still,
    rounding compounds with depth (``state_rel_err_deep``, the worst over
    every mamba layer).  ``kv_rel_err_by_layer`` and
    ``state_rel_err_by_layer`` give each layer's worst, ``[layer, the
    program's, the control's]``; ``node_errors`` each restored node's
    worst over every layer.  With ``control`` the fp8 pass's numbers come
    under ``control_*``."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _check(cfg, weights, prompt, outputs, k_tokens, width, device, control)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _check(cfg, weights, prompt, outputs, k_tokens, width, device, control):
    S = outputs["prompt_len"]
    nodes = outputs["nodes"]
    tok = lambda xs: torch.as_tensor(xs, dtype=torch.int64, device=device)
    suffixes = [tok(n["tail"][: n["seq_len"] - S]) for n in nodes]
    ref = Pass(Plain(cfg, weights), tok(prompt), suffixes)
    ctl = Pass(Plain(cfg, weights, fp8=True), tok(prompt), suffixes) if control else None
    err = {"trunk": 0.0, "fast": 0.0, "slow": 0.0, "slow_own": 0.0, "control": 0.0,
           "state_trunk": 0.0, "state_fast": 0.0, "state_slow": 0.0, "control_state": 0.0}
    per_node = [(0.0, -1, "", 0.0)] * len(nodes)    # worst (error, layer, leaf, own positions')
    by_layer = {"kv": [], "state": []}               # [layer, program's worst, control's]
    trunk, trunk_state = outputs["trunk"], outputs["trunk_state"]
    P = len(ref.p.period)
    L = cfg["num_hidden_layers"]
    first_moe = next((i for i in range(L) if ref.p.kinds(i)[1] == "moe"), L - 1)
    # the mamba layers whose input no MoE router has shaped: state_rel_err's
    sharp = [i for i in range(first_moe + 1) if ref.p.kinds(i)[0] == "mamba"]
    a = 0                                            # attention layers so far
    for i in range(L):
        W = ref.p.layer(i)
        mixer, want_t, want_n = ref.layer(W)
        del W
        worst = 0.0                                  # this layer's, the program's
        if mixer == "attn":
            k, v = want_t
            for name, want in (("k", k), ("v", v)):
                e = _rel(trunk[name][a].to(device), want)
                err["trunk"], worst = max(err["trunk"], e), max(worst, e)
            for j, (n, (ki, vi)) in enumerate(zip(nodes, want_n)):
                if n.get("kv") is None:
                    continue
                for name, want_tr, want_s in (("k", k, ki), ("v", v, vi)):
                    got = n["kv"][name][a].to(device)
                    whole = n["kv"]["lo"] < S
                    want = torch.cat([want_tr, want_s]) if whole else want_s
                    e = _rel(got, want)
                    own = (_rel(got[got.shape[0] - want_s.shape[0]:], want_s)
                           if want_s.shape[0] else 0.0)
                    err[n["path"]] = max(err[n["path"]], e)
                    if whole:
                        err["slow_own"] = max(err["slow_own"], own)
                    worst = max(worst, e, own)
                    if max(e, own) > max(per_node[j][0], per_node[j][3]):
                        per_node[j] = (e, i, name, own)
        else:
            tag, r = f"l{i % P}_s0_mamba", i // P
            early = i in sharp
            for leaf, want in zip(("conv", "ssm"), want_t):
                e = _rel(trunk_state[tag][leaf][r].to(device), want)
                worst = max(worst, e)
                if early:
                    err["state_trunk"] = max(err["state_trunk"], e)
            for j, (n, want_s) in enumerate(zip(nodes, want_n)):
                if n.get("state") is None:
                    continue
                for leaf, want in zip(("conv", "ssm"), want_s):
                    e = _rel(n["state"][tag][leaf][r].to(device), want)
                    worst = max(worst, e)
                    if early:
                        err["state_" + n["path"]] = max(err["state_" + n["path"]], e)
                    if e > max(per_node[j][0], per_node[j][3]):
                        per_node[j] = (e, i, leaf, 0.0)
        row = [i, round(worst, 6), None]
        if ctl is not None:
            Wc = ctl.p.layer(i)
            _, got_t, got_n = ctl.layer(Wc)
            del Wc
            pairs = list(zip(got_t, want_t)) + [(g, w) for x, y in zip(got_n, want_n)
                                                for g, w in zip(x, y)]
            c = max([0.0] + [_rel(got, want) for got, want in pairs])
            row[2] = round(c, 6)
            if mixer == "attn":
                err["control"] = max(err["control"], c)
            elif i in sharp:
                err["control_state"] = max(err["control_state"], c)
        by_layer["kv" if mixer == "attn" else "state"].append(row)
        if mixer == "attn":
            a += 1
    last, node_logits = ref.logits()
    if ctl is not None:
        c_last, c_nodes = ctl.logits()
    gaps, ctl_gaps, seen = [], [], set()
    for j, (n, lg) in enumerate(zip(nodes, node_logits)):
        rows = torch.cat([last[None], lg])            # logits at positions S-1 .. seq_len-1
        crow = torch.cat([c_last[None], c_nodes[j]]) if ctl is not None else None
        depth = (n["seq_len"] - S) // k_tokens
        for r in range(rows.shape[0]):
            key = tuple(n["tail"][: r + 1])          # one served position, judged once
            if key in seen:
                continue
            seen.add(key)
            rank = width if (r % k_tokens == 0 and r < depth * k_tokens) else 1
            top = torch.topk(rows[r], rank).values[-1]
            gaps.append(float(top - rows[r][n["tail"][r]]))
            if crow is not None:
                ctl_gaps.append(float(top - rows[r][int(torch.argmax(crow[r]))]))
    restored = [(n, w) for n, w in zip(nodes, per_node) if n.get("kv") is not None]
    out = {
        "logit_gap": max([0.0] + gaps),
        "kv_rel_err": max(err["trunk"], err["fast"], err["slow"], err["slow_own"]),
        "state_rel_err": max(err["state_trunk"], err["state_fast"], err["state_slow"]),
        "state_rel_err_deep": max([0.0] + [row[1] for row in by_layer["state"]]),
        "kv_rel_err_trunk": err["trunk"],
        "kv_rel_err_fast": err["fast"],
        "kv_rel_err_slow": err["slow"],
        "kv_rel_err_slow_own": err["slow_own"],
        "state_rel_err_trunk": err["state_trunk"],
        "state_rel_err_fast": err["state_fast"],
        "state_rel_err_slow": err["state_slow"],
        "state_layers": sharp,
        "kv_rel_err_by_layer": by_layer["kv"],
        "state_rel_err_by_layer": by_layer["state"],
        "tokens_judged": len(gaps),
        "nodes_judged": len(nodes),
        "nodes_restored": len(restored),
        "slow_nodes": sum(n["path"] == "slow" for n, _ in restored),
        "node_errors": [[n["ckpt"], n["path"], n["depth"], round(e, 6), layer, name, round(own, 6)]
                        for n, (e, layer, name, own) in restored],
    }
    if ctl is not None:
        out["control_logit_gap"] = max([0.0] + ctl_gaps)
        out["control_kv_rel_err"] = err["control"]
        out["control_state_rel_err"] = err["control_state"]
        out["control_state_rel_err_deep"] = max([0.0] + [row[2] for row in by_layer["state"]])
    return out
