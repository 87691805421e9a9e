"""The jamba family (Mamba-1 and attention layers, dense and MoE FFNs) in
the port: its ``ModelConfig`` from a configuration file of
``bench/configs/``, and the weights the benchmark draws for it.

The layer order comes from the configuration's offsets and periods, as
``JambaConfig.layers_block_type`` and ``layers_num_experts`` give it:
layer i is attention iff ``i % attn_layer_period == attn_layer_offset``
and MoE iff ``i % expert_layer_period == expert_layer_offset``.  The
port stacks one period of ``lcm`` of the two periods.  An MoE layer holds
the experts ``experts_held`` (a range of the router's ``router_experts``
ids); ``num_experts`` counts them.

The weights are the benchmark's inputs: drawn here from the run's seed,
on the device, in the dtype they are served in, one call per stacked
layer, and handed both to the port (``Model(params=...)``) and, later,
to the plain reference.  The tree is laid out as the port takes its
params and checked against the port's ``param_shapes``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def period(cfg: Dict[str, Any]) -> List[Tuple[str, str]]:
    """One period of (mixer, FFN) kinds, from the offsets and periods."""
    pa, pe = cfg["attn_layer_period"], cfg["expert_layer_period"]
    n = pa * pe // math.gcd(pa, pe)
    if cfg["num_hidden_layers"] % n:
        raise ValueError(f"{cfg['num_hidden_layers']} layers are no whole number of periods of {n}")
    return [("attn" if i % pa == cfg["attn_layer_offset"] else "mamba",
             "moe" if i % pe == cfg["expert_layer_offset"] else "mlp") for i in range(n)]


def dims(cfg: Dict[str, Any]) -> Dict[str, int]:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    di = cfg["mamba_expand"] * d
    return {"d": d, "H": H, "KVH": cfg["num_key_value_heads"], "Hd": d // H,
            "f": cfg["intermediate_size"], "V": cfg["vocab_size"], "di": di,
            "ds": cfg["mamba_d_state"], "dc": cfg["mamba_d_conv"], "dr": cfg["mamba_dt_rank"],
            "E": cfg["router_experts"], "held": cfg["num_experts"],
            "N": cfg["num_hidden_layers"] // len(period(cfg))}


def _check_cfg(cfg: Dict[str, Any]) -> None:
    """What the port's layers compute, and nothing else."""
    d = cfg["hidden_size"]
    lo, hi = cfg["experts_held"]
    if hi - lo != cfg["num_experts"] or not 0 <= lo < hi <= cfg["router_experts"]:
        raise ValueError(f"experts_held {cfg['experts_held']} does not hold "
                         f"{cfg['num_experts']} of {cfg['router_experts']} experts")
    if cfg["mamba_dt_rank"] != max(1, d // 16):
        raise ValueError(f"the port's dt rank is hidden_size // 16, not {cfg['mamba_dt_rank']}")
    if not cfg["mamba_conv_bias"] or cfg["mamba_proj_bias"]:
        raise ValueError("the port's mamba has a conv bias and no projection bias")
    if cfg.get("sliding_window") is not None or cfg["hidden_act"] != "silu":
        raise ValueError("the port's jamba takes global attention and SwiGLU")


def weight_specs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """{path: (shape, dtype, init)} of every weight: ``init`` a std, None
    for ones, or a name: "zeros", "dt_bias", "A_log"."""
    _check_cfg(cfg)
    k = dims(cfg)
    d, f, di, ds, dr, N = k["d"], k["f"], k["di"], k["ds"], k["dr"], k["N"]
    H, KVH, Hd = k["H"], k["KVH"], k["Hd"]
    dt = DTYPES[cfg["torch_dtype"]]
    f32 = torch.float32
    s_in = 1.0 / math.sqrt(d)
    specs = {
        "embed": ((k["V"], d), dt, float(cfg.get("embed_std", s_in))),
        "final_norm/scale": ((d,), dt, None),
        "lm_head": ((k["V"], d), dt, s_in),
    }
    for li, (mixer, ffn) in enumerate(period(cfg)):
        m = f"stage0/l{li}_s0_{mixer}"
        specs[f"{m}/norm/scale"] = ((N, d), dt, None)
        if mixer == "attn":
            specs.update({
                f"{m}/body/wq": ((N, d, KVH, H // KVH, Hd), dt, s_in),
                f"{m}/body/wk": ((N, d, KVH, Hd), dt, s_in),
                f"{m}/body/wv": ((N, d, KVH, Hd), dt, s_in),
                f"{m}/body/wo": ((N, KVH, H // KVH, Hd, d), dt, 1.0 / math.sqrt(H * Hd)),
            })
        else:
            specs.update({
                f"{m}/body/w_in": ((N, d, 2 * di), dt, s_in),
                f"{m}/body/conv_w": ((N, k["dc"], di), dt, 0.5),
                f"{m}/body/conv_b": ((N, di), dt, "zeros"),
                f"{m}/body/w_x_dbc": ((N, di, dr + 2 * ds), dt, 1.0 / math.sqrt(di)),
                f"{m}/body/w_dt": ((N, dr, di), dt, 1.0 / math.sqrt(dr)),
                f"{m}/body/dt_bias": ((N, di), f32, "dt_bias"),
                f"{m}/body/A_log": ((N, di, ds), f32, "A_log"),
                f"{m}/body/D": ((N, di), f32, None),
                f"{m}/body/w_out": ((N, di, d), dt, 1.0 / math.sqrt(di)),
                f"{m}/body/dt_norm/scale": ((N, dr), dt, None),
                f"{m}/body/b_norm/scale": ((N, ds), dt, None),
                f"{m}/body/c_norm/scale": ((N, ds), dt, None),
            })
        g = f"stage0/l{li}_s1_{ffn}"
        specs[f"{g}/norm/scale"] = ((N, d), dt, None)
        if ffn == "moe":
            e = k["held"]
            specs.update({
                f"{g}/body/router": ((N, d, k["E"]), f32, s_in),
                f"{g}/body/w_gate": ((N, e, d, f), dt, s_in),
                f"{g}/body/w_up": ((N, e, d, f), dt, s_in),
                f"{g}/body/w_down": ((N, e, f, d), dt, 1.0 / math.sqrt(f)),
            })
        else:
            specs.update({
                f"{g}/body/w_gate": ((N, d, f), dt, s_in),
                f"{g}/body/w_up": ((N, d, f), dt, s_in),
                f"{g}/body/w_down": ((N, f, d), dt, 1.0 / math.sqrt(f)),
            })
    return specs


def _fill(t: torch.Tensor, init: Any, gen: torch.Generator) -> None:
    if init is None:
        t.fill_(1.0)
    elif init == "zeros":
        t.zero_()
    elif init == "A_log":
        t.copy_(torch.log(torch.arange(1, t.shape[-1] + 1, dtype=torch.float32,
                                       device=t.device)).expand(t.shape))
    elif init == "dt_bias":
        # dt log-uniform in [1e-3, 1e-1], stored as softplus^-1(dt)
        u = torch.rand(t.shape, generator=gen, device=t.device, dtype=torch.float32)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        t.copy_(torch.log(torch.expm1(dt)))
    else:
        for row in (t if t.dim() > 2 else [t]):           # one call per stacked layer
            row.normal_(0.0, init, generator=gen)


def draw_weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The weights of ``cfg`` from ``seed`` on ``device``, as a nested dict
    in the port's layout.  The port's ``ModelConfig`` is made first, so a
    port without jamba's options fails before anything is drawn."""
    port_config(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    tree: Dict[str, Any] = {}
    for path, (shape, dtype, init) in weight_specs(cfg).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        _fill(t, init, gen)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def port_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` of ``cfg``."""
    from repro_torch.configs.base import ModelConfig, Stage

    _check_cfg(cfg)
    k = dims(cfg)
    per = tuple(period(cfg))
    return ModelConfig(
        name=cfg["name"],
        family="hybrid",
        stages=(Stage(period=per, n_periods=k["N"]),),
        d_model=k["d"],
        n_heads=k["H"],
        n_kv_heads=k["KVH"],
        head_dim=k["Hd"],
        d_ff=k["f"],
        vocab_size=k["V"],
        rope=False,
        n_experts=k["E"],
        top_k=cfg["num_experts_per_tok"],
        moe_d_ff=k["f"],
        moe_renormalize=False,
        moe_dropless=True,
        experts_held=tuple(cfg["experts_held"]),
        mamba_d_state=k["ds"],
        mamba_d_conv=k["dc"],
        mamba_expand=cfg["mamba_expand"],
        mamba_inner_norm=True,
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
    model's matmul FLOPs (2 per weight a row meets: mamba's in_proj, x_proj,
    dt_proj and out_proj, attention's projections, the dense FFNs, each MoE
    layer's router and, on average, ``top_k × held / router_experts`` of
    the held experts, the head), attention's FLOPs per position (q.k and
    p.v in every head of the attention layers), and the bytes
    ``paged_attention`` has to move: a position's keys and values in every
    attention layer, and per row and attention layer its query, its output
    and its length."""
    k = dims(cfg)
    d, f, di, ds, dr, N = k["d"], k["f"], k["di"], k["ds"], k["dr"], k["N"]
    H, KVH, Hd = k["H"], k["KVH"], k["Hd"]
    item = torch.tensor([], dtype=DTYPES[cfg["torch_dtype"]]).element_size()
    per = period(cfg)
    n_attn = N * sum(m == "attn" for m, _ in per)
    n_mamba = N * sum(m == "mamba" for m, _ in per)
    n_moe = N * sum(g == "moe" for _, g in per)
    n_mlp = N * sum(g == "mlp" for _, g in per)
    attn = d * H * Hd + 2 * d * KVH * Hd + H * Hd * d
    mamba = d * 2 * di + di * (dr + 2 * ds) + dr * di + di * d
    experts = cfg["num_experts_per_tok"] * k["held"] / k["E"]
    moe = d * k["E"] + experts * 3 * d * f
    weights = attn * n_attn + mamba * n_mamba + 3 * d * f * n_mlp + moe * n_moe + k["V"] * d
    return {
        "matmul_flops_per_row": 2.0 * weights,
        "attn_flops_per_position": 4.0 * H * Hd * n_attn,
        "pa_bytes_per_position": 2.0 * KVH * Hd * item * n_attn,
        "pa_bytes_per_row": (2.0 * H * Hd * item + 4) * n_attn,
    }
