"""Plain reference of the qwen3_moe family, and the check that holds the
program's search to it.

Plain PyTorch in float32 (TF32 off): Qwen3-MoE as published
(``Qwen3MoeForCausalLM``, ``Qwen3MoeSparseMoeBlock``).  Every layer's MoE
softmaxes the router's logits over all experts in float32, takes the top
k, renormalizes their weights (``norm_topk_prob``) and sums the k
experts' SwiGLU outputs, each weighted by its gate: every assignment
reaches its expert (dropless), at the prompt and at every decoded token.
The embedding, RMSNorm, attention with q and k RMSNorm and rotary
embeddings, and the head are the qwen3 reference's (``Plain`` and ``Pass``
of ``bench/reference/qwen3.py``), and so is the pass: the trunk once, each
sampled node's tokens over the trunk's keys and values, layer by layer,
each layer's weights made float32 only while it runs, and each node's
logits taken and judged in turn.  The only departure from the published
model is the weights, which are random.

With ``control`` the same pass runs a second time beside it in fp8 (e4m3,
weights scaled per tensor, each expert its own, every matmul's input per
row): the precision below the configuration's bfloat16.  Its readings,
held to the limits in the program's place, are what the limits must
reject.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Any, Dict, List

import torch


def _load_qwen3():
    """``bench/reference/qwen3.py``, the file beside this one (a reference
    imports nothing of the benchmark's harness or of the port)."""
    spec = importlib.util.spec_from_file_location("bench_reference_qwen3_of_moe",
                                                  Path(__file__).with_name("qwen3.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_qwen3 = _load_qwen3()
Pass = _qwen3.Pass
_rel = _qwen3._rel
EARLY_LAYERS = (0, 1)     # the layers whose input at most layer 0's router has shaped


class Plain(_qwen3.Plain):
    """The qwen3 reference's pass with the published dropless MoE, and its
    head made float32 (or fp8) once, not at every call."""

    _head_w = None

    def head(self, x: torch.Tensor) -> torch.Tensor:
        if self._head_w is None:
            self._head_w = self._f(self.w["lm_head"])
        return self.mm(self.rms(x, self.w["final_norm"]["scale"].float()), self._head_w.T)

    def moe_ffn(self, W, h: torch.Tensor, group: int) -> torch.Tensor:
        """Top-k of the float32 softmax over every expert, renormalized,
        each token through its k experts; ``group`` (the qwen3 reference's
        capacity groups) plays no part."""
        K = self.cfg["num_experts_per_tok"]
        probs = torch.softmax(h @ W["router"], dim=-1)
        gate, ids = torch.topk(probs, K, dim=-1)                      # (T, K)
        gate = gate / gate.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in range(self.cfg["num_experts"]):
            t_idx, k_idx = torch.nonzero(ids == e, as_tuple=True)
            if t_idx.numel() == 0:
                continue
            x = h[t_idx]
            y = torch.nn.functional.silu(self.mm(x, W["w_gate"][e])) * self.mm(x, W["w_up"][e])
            y = self.mm(y, W["w_down"][e])
            out.index_add_(0, t_idx, y * gate[t_idx, k_idx][:, None])
        return out


def check(cfg: Dict[str, Any], weights: Dict[str, Any], prompt: List[int],
          outputs: Dict[str, Any], *, k_tokens: int, width: int, device,
          control: bool = False) -> Dict[str, Any]:
    """The numbers compared.

    ``outputs`` is the ``search`` driver's (``bench/reference/qwen3.py``'s
    ``check`` says what it holds), and so are ``logit_gap`` and
    ``kv_rel_err``, which stay against gross faults.  ``kv_rel_err_early``
    is ``kv_rel_err`` over layers 0 and 1 alone (``early_layers``): layer
    0's keys and values come from the embedding through attention, layer
    1's through layer 0's MoE, so only one router stands before them.
    Deeper, a token whose bfloat16 router logits differ from float32's by a
    hair takes another of its 8 experts, and its keys and values in every
    later layer move by more than rounding, so the worst layer reads high
    in a sound run too.  ``kv_rel_err_by_layer`` gives each layer's worst,
    ``[layer, the program's, the control's]``.  With ``control`` the fp8
    pass's numbers come under ``control_*``."""
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
    err = {"trunk": 0.0, "fast": 0.0, "slow": 0.0, "slow_own": 0.0, "early": 0.0,
           "control": 0.0, "control_early": 0.0}
    per_node = [(0.0, -1, "", 0.0)] * len(nodes)    # worst (error, layer, k|v, own positions')
    by_layer = []                                    # [layer, program's worst, control's]
    trunk = outputs["trunk"]
    for i in range(cfg["num_hidden_layers"]):
        W = ref.p.layer(i)
        (k, v), kvs = ref.layer(W)
        del W
        worst = 0.0
        for name, want in (("k", k), ("v", v)):
            e = _rel(trunk[name][i].to(device), want)
            err["trunk"], worst = max(err["trunk"], e), max(worst, e)
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
                worst = max(worst, e, own)
                if max(e, own) > max(per_node[j][0], per_node[j][3]):
                    per_node[j] = (e, i, name, own)
        if i in EARLY_LAYERS:
            err["early"] = max(err["early"], worst)
        row = [i, round(worst, 6), None]
        if ctl is not None:
            Wc = ctl.p.layer(i)
            (kc, vc), kvc = ctl.layer(Wc)
            del Wc
            c = max(_rel(got, want) for got, want in [(kc, k), (vc, v)] + [
                (a, b) for x, y in zip(kvc, kvs) for a, b in zip(x, y)])
            err["control"] = max(err["control"], c)
            if i in EARLY_LAYERS:
                err["control_early"] = max(err["control_early"], c)
            row[2] = round(c, 6)
        by_layer.append(row)
    # one node's logits at a time: all of them at once (V = 151,936 columns)
    # would not fit beside the weights
    last = ref.p.head(ref.x[-1:])
    c_last = ctl.p.head(ctl.x[-1:]) if ctl is not None else None
    gaps, ctl_gaps, seen = [], [], set()
    for j, n in enumerate(nodes):
        rows = torch.cat([last, ref.p.head(ref.xs[j])])   # logits at positions S-1 .. seq_len-1
        crow = torch.cat([c_last, ctl.p.head(ctl.xs[j])]) if ctl is not None else None
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
        "kv_rel_err_early": err["early"],
        "kv_rel_err_trunk": err["trunk"],
        "kv_rel_err_fast": err["fast"],
        "kv_rel_err_slow": err["slow"],
        "kv_rel_err_slow_own": err["slow_own"],
        "early_layers": list(EARLY_LAYERS),
        "kv_rel_err_by_layer": by_layer,
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
        out["control_kv_rel_err_early"] = err["control_early"]
    return out
