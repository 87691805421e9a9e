"""The qwen3_moe family: Qwen3-MoE as published (``Qwen3MoeForCausalLM``)
in the port, a dropless MoE in every layer whose top-k weights are
renormalized (``norm_topk_prob``).

The weights, their layout and the attention are the qwen3 family's
(``bench/models/qwen3.py``); this module makes the port's ``ModelConfig``
dropless (``moe_dropless``, ``moe_renormalize``), so that a decode step
reads only the experts its rows routed to (``kernels.moe_decode``), and
adds to ``decode_costs`` what that kernel has to move.  A port without
that kernel fails at once, before any weight is drawn.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from bench.harness import registry

_qwen3 = registry.load_module("models", "qwen3")
DTYPES = _qwen3.DTYPES
weight_specs = _qwen3.weight_specs


def _check_cfg(cfg: Dict[str, Any]) -> None:
    """What the port computes for this family, and nothing else."""
    if not _qwen3.is_moe(cfg) or not cfg["norm_topk_prob"]:
        raise ValueError("qwen3_moe is a top-k MoE with renormalized weights")
    if "capacity_factor" in cfg:
        raise ValueError("qwen3_moe is dropless: a capacity_factor belongs to the qwen3 family")
    if cfg["decoder_sparse_step"] != 1 or cfg["mlp_only_layers"]:
        raise ValueError("the port's qwen3_moe has an MoE in every layer")
    if cfg.get("sliding_window") is not None or cfg["hidden_act"] != "silu":
        raise ValueError("the port's qwen3_moe takes global attention and SwiGLU experts")


def port_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` of ``cfg``: the qwen3 family's, dropless
    and renormalized."""
    from repro_torch.kernels import moe_decode  # noqa: F401  (the routed-experts decode)

    _check_cfg(cfg)
    return dataclasses.replace(_qwen3.port_config(cfg), moe_dropless=True, moe_renormalize=True)


def draw_weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The qwen3 family's weights of ``cfg``; the port's ``ModelConfig`` is
    made first."""
    port_config(cfg)
    return _qwen3.draw_weights(cfg, seed, device)


def build(cfg: Dict[str, Any], weights: Dict[str, Any], device):
    """The port's ``Model`` of ``cfg`` over ``weights`` (not copied)."""
    from repro_torch.models import Model

    model = Model(port_config(cfg), device=device)
    _qwen3._check_layout(model.param_shapes(), weights, "")
    model.params = weights
    return model


def decode_costs(cfg: Dict[str, Any]) -> Dict[str, float]:
    """The qwen3 family's decode costs, and what the decode MoE kernel has
    to move in a step: ``moe_expert_bytes``, the three matrices of one
    routed expert (read once a step however many rows it serves), and
    ``moe_row_bytes``, a row's activations over all the MoE layers (its
    normed hidden state in, its output out, its ids and gates)."""
    d, f, L = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_hidden_layers"]
    item = DTYPES[cfg["torch_dtype"]].itemsize
    out = dict(_qwen3.decode_costs(cfg))
    out["moe_expert_bytes"] = 3.0 * d * f * item
    out["moe_row_bytes"] = float(L * (2 * d * item + 8 * cfg["num_experts_per_tok"]))
    return out
