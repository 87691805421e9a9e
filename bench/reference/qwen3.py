"""Plain reference of the qwen3 family (dense and MoE), and the check that
holds the program's search to it.

Plain PyTorch in float32 (TF32 off), following Qwen3's published
description: RMSNorm (eps 1e-6), q and k RMSNorm over each head before
rotary embeddings (rotate-half, theta from the configuration), grouped
query attention scaled by 1/sqrt(head_dim), SwiGLU, untied head.  The MoE
layer softmaxes the router's logits over every expert, takes the top k and
renormalizes their weights; one departure from the published (dropless)
model is the configuration's own: ``capacity_factor`` bounds each
expert's slots per group of tokens (a prefill's whole prompt, a decode
step's one token), slots taken in token-major order, and an assignment
past capacity skips its expert.

It takes the weights and tokens the benchmark made and works out the rest
again: the trunk's keys, values and logits, and each sampled node's over
its own tokens.  The trunk is computed once, a node's tokens attend to the
trunk's keys and values of the same layer and to their own: the same
arithmetic as one causal pass over the node's whole sequence.  It runs
layer by layer, each layer's weights made float32 only while it runs, and
holds the program's keys and values against its own as each layer ends.

With ``control`` the same pass runs a second time beside it in fp8 (e4m3,
weights scaled per tensor, every matmul's input per row): the precision
below the configuration's bfloat16.  Its readings, held to the limits in
the program's place, are what the limits must reject.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

ATTN_BLOCK = 512          # query rows per block of the trunk's attention
FP8_MAX = 448.0           # largest finite float8_e4m3fn


def _fq(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``t`` through float8 e4m3 and back, scaled per tensor (``dim``
    None) or per slice along ``dim``."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = (amax / FP8_MAX).clamp_min(1e-12)
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Plain:
    """One precision's pass: ``fp8`` fake-quantizes weights and matmul
    inputs, else everything is float32."""

    def __init__(self, cfg: Dict[str, Any], weights: Dict[str, Any], fp8: bool = False):
        self.cfg, self.w, self.fp8 = cfg, weights, fp8
        self.d = cfg["hidden_size"]
        self.H, self.KVH, self.Hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                                     cfg["head_dim"])
        self.G = self.H // self.KVH
        self.eps = float(cfg["rms_norm_eps"])
        self.moe = int(cfg.get("num_experts", 0)) > 0
        self.ffn = "l0_s1_moe" if self.moe else "l0_s1_mlp"

    # ------------------------------------------------------------ weights
    def _f(self, t: torch.Tensor, matrix: bool = True) -> torch.Tensor:
        t = t.float()
        return _fq(t, None) if (self.fp8 and matrix) else t

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        s = self.w["stage0"]
        a, f = s["l0_s0_attn"], s[self.ffn]
        d, H, KVH, Hd = self.d, self.H, self.KVH, self.Hd
        W = {
            "n1": a["norm"]["scale"][i].float(),
            "wq": self._f(a["body"]["wq"][i].reshape(d, H * Hd)),
            "wk": self._f(a["body"]["wk"][i].reshape(d, KVH * Hd)),
            "wv": self._f(a["body"]["wv"][i].reshape(d, KVH * Hd)),
            "wo": self._f(a["body"]["wo"][i].reshape(H * Hd, d)),
            "qn": a["body"]["q_norm"]["scale"][i].float(),
            "kn": a["body"]["k_norm"]["scale"][i].float(),
            "n2": f["norm"]["scale"][i].float(),
        }
        if self.moe:
            W["router"] = f["body"]["router"][i].float()
            for k in ("w_gate", "w_up", "w_down"):
                W[k] = torch.stack([self._f(e) for e in f["body"][k][i]])
        else:
            for k in ("w_gate", "w_up", "w_down"):
                W[k] = self._f(f["body"][k][i])
        return W

    # ----------------------------------------------------------- pieces
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fq(x, -1) if self.fp8 else x) @ w

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * scale

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (S, heads, Hd) at positions pos (S,)."""
        Hd = x.shape[-1]
        freqs = 1.0 / (float(self.cfg["rope_theta"]) **
                       (torch.arange(0, Hd, 2, dtype=torch.float32, device=x.device) / Hd))
        ang = pos.float()[:, None, None] * freqs
        c, s = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., : Hd // 2], x[..., Hd // 2:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def qkv(self, W, x: torch.Tensor, pos: torch.Tensor):
        h = self.rms(x, W["n1"])
        S = x.shape[0]
        q = self.mm(h, W["wq"]).reshape(S, self.H, self.Hd)
        k = self.mm(h, W["wk"]).reshape(S, self.KVH, self.Hd)
        v = self.mm(h, W["wv"]).reshape(S, self.KVH, self.Hd)
        q = self.rope(self.rms(q, W["qn"]), pos)
        k = self.rope(self.rms(k, W["kn"]), pos)
        return q, k, v

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

    def mlp(self, W, h: torch.Tensor, group: int) -> torch.Tensor:
        if not self.moe:
            g = self.mm(h, W["w_gate"])
            u = self.mm(h, W["w_up"])
            return self.mm(torch.nn.functional.silu(g) * u, W["w_down"])
        return self.moe_ffn(W, h, group)

    def moe_ffn(self, W, h: torch.Tensor, group: int) -> torch.Tensor:
        """Top-k MoE over tokens ``h`` (T, d) taken in groups of ``group``
        consecutive tokens, each expert holding ``capacity(group)`` slots
        per group."""
        cfg = self.cfg
        E, K = cfg["num_experts"], cfg["num_experts_per_tok"]
        T = h.shape[0]
        probs = torch.softmax(h @ W["router"], dim=-1)
        gate, ids = torch.topk(probs, K, dim=-1)                      # (T, K)
        if cfg.get("norm_topk_prob", True):
            gate = gate / gate.sum(-1, keepdim=True)
        c = math.ceil(group * K / E * float(cfg.get("capacity_factor", 1.25)))
        C = max(8, -(-c // 8) * 8)
        if T % group:
            raise ValueError(f"{T} tokens do not split into groups of {group}")
        # each assignment's slot: the earlier assignments of its group, in
        # token-major (t, k) order, to the same expert
        onehot = torch.zeros(T // group, group * K, E, dtype=torch.int64, device=h.device)
        onehot.scatter_(2, ids.reshape(T // group, group * K, 1), 1)
        slot = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
        keep = (slot < C).reshape(T, K)
        w = gate * keep
        out = torch.zeros_like(h)
        for e in range(E):
            t_idx, k_idx = torch.nonzero((ids == e) & keep, as_tuple=True)
            if t_idx.numel() == 0:
                continue
            x = h[t_idx]
            y = torch.nn.functional.silu(self.mm(x, W["w_gate"][e])) * self.mm(x, W["w_up"][e])
            y = self.mm(y, W["w_down"][e])
            out.index_add_(0, t_idx, y * w[t_idx, k_idx][:, None])
        return out

    def head(self, x: torch.Tensor) -> torch.Tensor:
        h = self.rms(x, self.w["final_norm"]["scale"].float())
        head = self._f(self.w["lm_head"])
        return self.mm(h, head.T)


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
        """Advance every sequence by one layer; returns the trunk's (k, v)
        and each node's."""
        p, S = self.p, self.S
        dev = self.x.device
        q, k, v = p.qkv(W, self.x, torch.arange(S, device=dev))
        self.x = self.x + p.mm(p.attend(q, k, v, 0), W["wo"])
        self.x = self.x + p.mlp(W, p.rms(self.x, W["n2"]), group=S)
        kvs = []
        for i, xs in enumerate(self.xs):
            n = xs.shape[0]
            qi, ki, vi = p.qkv(W, xs, S + torch.arange(n, device=dev))
            ctx = p.attend(qi, torch.cat([k, ki]), torch.cat([v, vi]), S)
            self.xs[i] = xs + p.mm(ctx, W["wo"])
            kvs.append((ki, vi))
        if self.xs:
            # a decode step's MoE groups are single tokens
            cat = torch.cat(self.xs)
            moved = cat + p.mlp(W, p.rms(cat, W["n2"]), group=1)
            self.xs = list(moved.split([x.shape[0] for x in self.xs]))
        return (k, v), kvs

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

    ``outputs`` holds ``prompt_len``, the trunk's K/V (``trunk``) and
    ``nodes``: each with its ``tail`` (its tokens from the prompt's end,
    the pending one last), ``seq_len``, ``depth`` and, for a node restored
    for the check, ``path`` and ``kv`` (the program's K/V of positions
    ``kv["lo"]`` on).

    ``logit_gap`` is the widest gap by which a served token's reference
    logit lies below the reference's best (below its ``width``-th best for
    an action, which the search takes among the top ``width``), over every
    distinct served position of every node.  ``kv_rel_err`` is the largest
    relative error (Frobenius, per layer, K and V apart) of the program's
    keys and values: the trunk's prefill, each fast-forked node's own
    positions, and each slow-restored node's every position and, held
    apart, its own positions, so that a fault in a node's few own pages is
    not lost under the trunk's thousands.  With ``control`` the fp8 pass's
    two numbers come under ``control_*``: its keys and values against
    float32's, and at each position the gap of the token fp8 puts first,
    scored by the same rank rule."""
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
    err = {"trunk": 0.0, "fast": 0.0, "slow": 0.0, "slow_own": 0.0, "control": 0.0}
    per_node = [(0.0, -1, "", 0.0)] * len(nodes)    # worst (error, layer, k|v, own positions')
    trunk = outputs["trunk"]
    for i in range(cfg["num_hidden_layers"]):
        W = ref.p.layer(i)
        (k, v), kvs = ref.layer(W)
        del W
        for name, want in (("k", k), ("v", v)):
            err["trunk"] = max(err["trunk"], _rel(trunk[name][i].to(device), want))
        for j, (n, (ki, vi)) in enumerate(zip(nodes, kvs)):
            if n.get("kv") is None:
                continue
            for name, want_t, want_s in (("k", k, ki), ("v", v, vi)):
                got = n["kv"][name][i].to(device)
                whole = n["kv"]["lo"] < S
                want = torch.cat([want_t, want_s]) if whole else want_s
                e = _rel(got, want)
                own = _rel(got[got.shape[0] - want_s.shape[0]:], want_s) if want_s.shape[0] else 0.0
                err[n["path"]] = max(err[n["path"]], e)
                if whole:
                    err["slow_own"] = max(err["slow_own"], own)
                worst = per_node[j]
                if max(e, own) > max(worst[0], worst[3]):
                    per_node[j] = (e, i, name, own)
        if ctl is not None:
            Wc = ctl.p.layer(i)
            (kc, vc), kvc = ctl.layer(Wc)
            del Wc
            for got, want in [(kc, k), (vc, v)] + [(a, b) for x, y in zip(kvc, kvs)
                                                  for a, b in zip(x, y)]:
                err["control"] = max(err["control"], _rel(got, want))
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
        "kv_rel_err_trunk": err["trunk"],
        "kv_rel_err_fast": err["fast"],
        "kv_rel_err_slow": err["slow"],
        "kv_rel_err_slow_own": err["slow_own"],
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
    return out
