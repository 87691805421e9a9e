"""The qwen3 family (dense and MoE) in the port: its ``ModelConfig`` from a
configuration file of ``bench/configs/``, and the weights the benchmark
draws for it.

The weights are the benchmark's inputs: drawn here from the run's seed, on
the device, in the dtype they are served in, one call per stacked layer,
and handed both to the port (``Model(params=...)``) and, later, to the
plain reference.  The tree is laid out as the port takes its params; its
shapes are written out here from the configuration and checked against
the port's ``param_shapes`` before the port is given them.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def is_moe(cfg: Dict[str, Any]) -> bool:
    return int(cfg.get("num_experts", 0)) > 0


def weight_specs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """{path: (shape, dtype, std)} of every weight; std None means ones."""
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    H, KVH, Hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    G = H // KVH
    dt = DTYPES[cfg["torch_dtype"]]
    s_in = 1.0 / math.sqrt(d)
    specs = {
        "embed": ((V, d), dt, cfg.get("embed_std", s_in)),
        "final_norm/scale": ((d,), dt, None),
        "lm_head": ((V, d), dt, s_in),
        "stage0/l0_s0_attn/norm/scale": ((L, d), dt, None),
        "stage0/l0_s0_attn/body/wq": ((L, d, KVH, G, Hd), dt, s_in),
        "stage0/l0_s0_attn/body/wk": ((L, d, KVH, Hd), dt, s_in),
        "stage0/l0_s0_attn/body/wv": ((L, d, KVH, Hd), dt, s_in),
        "stage0/l0_s0_attn/body/wo": ((L, KVH, G, Hd, d), dt, 1.0 / math.sqrt(H * Hd)),
        "stage0/l0_s0_attn/body/q_norm/scale": ((L, Hd), dt, None),
        "stage0/l0_s0_attn/body/k_norm/scale": ((L, Hd), dt, None),
    }
    if is_moe(cfg):
        E, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        ffn = "stage0/l0_s1_moe"
        specs.update({
            f"{ffn}/norm/scale": ((L, d), dt, None),
            f"{ffn}/body/router": ((L, d, E), torch.float32, s_in),
            f"{ffn}/body/w_gate": ((L, E, d, f), dt, s_in),
            f"{ffn}/body/w_up": ((L, E, d, f), dt, s_in),
            f"{ffn}/body/w_down": ((L, E, f, d), dt, 1.0 / math.sqrt(f)),
        })
    else:
        f = cfg["intermediate_size"]
        ffn = "stage0/l0_s1_mlp"
        specs.update({
            f"{ffn}/norm/scale": ((L, d), dt, None),
            f"{ffn}/body/w_gate": ((L, d, f), dt, s_in),
            f"{ffn}/body/w_up": ((L, d, f), dt, s_in),
            f"{ffn}/body/w_down": ((L, f, d), dt, 1.0 / math.sqrt(f)),
        })
    return specs


def draw_weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The weights of ``cfg`` from ``seed`` on ``device``, as a nested dict
    in the port's layout."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    tree: Dict[str, Any] = {}
    for path, (shape, dtype, std) in weight_specs(cfg).items():
        if std is None:
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.empty(shape, dtype=dtype, device=device)
            for row in (t if len(shape) > 2 else [t]):     # one call per stacked layer
                row.normal_(0.0, std, generator=gen)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def port_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` of ``cfg``."""
    from repro_torch.configs.base import ModelConfig, Stage

    moe = is_moe(cfg)
    return ModelConfig(
        name=cfg["name"],
        family="moe" if moe else "dense",
        stages=(Stage(period=(("attn", "moe" if moe else "mlp"),),
                      n_periods=cfg["num_hidden_layers"]),),
        d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"],
        d_ff=cfg["moe_intermediate_size"] if moe else cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"],
        qk_norm=True,
        rope_theta=float(cfg["rope_theta"]),
        n_experts=cfg.get("num_experts", 0),
        top_k=cfg.get("num_experts_per_tok", 0),
        moe_d_ff=cfg.get("moe_intermediate_size", 0),
        capacity_factor=float(cfg.get("capacity_factor", 1.25)),
        activation=cfg["hidden_act"],
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        dtype=cfg["torch_dtype"],
        param_dtype=cfg["torch_dtype"],
        source=cfg["source"],
    )


def build(cfg: Dict[str, Any], weights: Dict[str, Any], device):
    """The port's ``Model`` of ``cfg`` over ``weights`` (not copied)."""
    from repro_torch.models import Model

    model = Model(port_config(cfg), device=device)
    _check_layout(model.param_shapes(), weights, "")
    model.params = weights
    return model


def _check_layout(want: Any, got: Any, path: str) -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(want) != sorted(got):
            raise ValueError(f"weights at {path or '/'}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _check_layout(want[k], got[k], f"{path}/{k}")
    elif tuple(want.shape) != tuple(got.shape) or want.dtype != got.dtype:
        raise ValueError(f"weights at {path}: {tuple(got.shape)} {got.dtype}, "
                         f"the port takes {tuple(want.shape)} {want.dtype}")


def decode_costs(cfg: Dict[str, Any]) -> Dict[str, float]:
    """What one decode step needs, per row and per attended position: the
    model's matmul FLOPs (2 per weight a row meets: the projections, the
    FFN or the routed experts and the router, the head), attention's FLOPs
    per position (q.k and p.v in every head of every layer), and the bytes
    ``paged_attention`` has to move: a position's keys and values in every
    layer, and per row and layer its query, its output and its length (its
    page table's few entries are left out)."""
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    H, KVH, Hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    item = torch.tensor([], dtype=DTYPES[cfg["torch_dtype"]]).element_size()
    attn = d * H * Hd + 2 * d * KVH * Hd + H * Hd * d
    if is_moe(cfg):
        ffn = d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d * cfg["moe_intermediate_size"]
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return {
        "matmul_flops_per_row": 2.0 * ((attn + ffn) * L + V * d),
        "attn_flops_per_position": 4.0 * H * Hd * L,
        "pa_bytes_per_position": 2.0 * KVH * Hd * item * L,
        "pa_bytes_per_row": (2.0 * H * Hd * item + 4) * L,
    }
