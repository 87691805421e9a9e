"""One decode step of a dropless top-k MoE layer over its routed experts.

``moe_decode(x, ids, gates, w_gate, w_up, w_down, held=(lo, hi))`` gives,
for each row b of ``x`` (B, d),

    y[b] = sum_k gates[b, k] * w_down[e]^T (silu(w_gate[e]^T x[b]) * w_up[e]^T x[b])

with ``e = ids[b, k] - lo``; an id outside the held experts ``[lo, hi)``
adds nothing (expert parallelism's share of a layer).  The sums are float32
and ``y`` is cast to ``x``'s type once.

CUDA kernel ``csrc/moe_decode.cu`` replaces no kernel of the JAX package,
whose MoE decode dispatches every row into capacity slots of every expert
and multiplies all of them (the port's all-experts ``bmm``,
``layers._moe_expert_ffn``).  At a decode step's few rows that reads every
held expert's weights: 58 GB a step for Qwen3-30B-A3B, where 3 rows route to
about 22 of its 128 experts a layer.  On the card the work is bound by the
bytes of the distinct routed experts' three matrices (``expert_bytes`` each)
over 3.35 TB/s.  The design reads each routed expert's weights once, in
three launches: the ids are ranked on the device (no host read, static
shapes, so a CUDA graph captures it); one block per (routed expert,
column tile of f) streams the gate and up tiles, then one per (routed
expert, column tile of d, split of 2048 rows of f) the down tile, two
blocks an SM, with tiles half as wide where the step's experts would give
an SM fewer than two; a last launch sums each row's slots in a fixed
order.  No floating-point atomics.

A tensor on the CPU goes to :func:`moe_decode_ref`, the plain version with
the same float32 arithmetic; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build, accounting

__all__ = ["F_SPLIT", "MAX_SLOTS", "expert_bytes", "moe_decode", "moe_decode_ref"]

F_SPLIT = 2048            # rows of f a block of the down launch takes
MAX_SLOTS = 256           # B * K the kernel takes
LAUNCHES = 3              # gate/up, down, combine
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def expert_bytes(d: int, f: int, itemsize: int) -> int:
    """The bytes of one expert's three matrices: what the kernel reads of
    each distinct routed expert a step."""
    return 3 * d * f * itemsize


def moe_decode_ref(x: torch.Tensor, ids: torch.Tensor, gates: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                   held: Tuple[int, int]) -> torch.Tensor:
    """The plain version: each slot's expert gathered and run in float32,
    the slots summed in k order, one cast.  No host read, so a step that
    calls it stays capturable."""
    lo, hi = held
    xf = x.float()[:, None, :]                                      # (B, 1, d)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(ids.shape[1]):
        e = ids[:, k].long()
        here = (e >= lo) & (e < hi)
        loc = torch.where(here, e - lo, torch.zeros_like(e))
        gate = torch.nn.functional.silu(torch.bmm(xf, w_gate[loc].float()))
        h = gate * torch.bmm(xf, w_up[loc].float())
        y = torch.bmm(h, w_down[loc].float())[:, 0]                 # (B, d)
        out += torch.where(here, gates[:, k].float(), torch.zeros_like(gates[:, k]))[:, None] * y
    return out.to(x.dtype)


def moe_decode(x: torch.Tensor, ids: torch.Tensor, gates: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, *,
               held: Tuple[int, int], activation: str = "silu") -> torch.Tensor:
    """See the module docstring: ``x`` (B, d), ``ids`` (B, K) int32,
    ``gates`` (B, K) float32, ``w_gate``/``w_up`` (hi - lo, d, f),
    ``w_down`` (hi - lo, f, d) in ``x``'s type; returns (B, d).  The
    experts' activation is silu, the one every dropless config uses."""
    if x.dim() != 2 or ids.dim() != 2 or gates.shape != ids.shape or ids.shape[0] != x.shape[0]:
        raise ValueError(f"moe_decode wants x (B, d) and ids, gates (B, K), got "
                         f"{tuple(x.shape)} / {tuple(ids.shape)} / {tuple(gates.shape)}")
    B, d = x.shape
    K = ids.shape[1]
    lo, hi = (int(v) for v in held)
    E, d_w, f = w_gate.shape
    if (E != hi - lo or d_w != d or w_up.shape != w_gate.shape
            or tuple(w_down.shape) != (E, f, d)):
        raise ValueError(f"moe_decode: experts {tuple(w_gate.shape)} / {tuple(w_up.shape)} / "
                         f"{tuple(w_down.shape)} do not hold {hi - lo} experts of width d={d}")
    if ids.dtype != torch.int32 or gates.dtype != torch.float32:
        raise TypeError(f"moe_decode wants int32 ids and float32 gates, got {ids.dtype} / "
                        f"{gates.dtype}")
    if not (x.dtype == w_gate.dtype == w_up.dtype == w_down.dtype):
        raise TypeError(f"moe_decode: x {x.dtype}, experts {w_gate.dtype} / {w_up.dtype} / "
                        f"{w_down.dtype}")
    if len({t.device for t in (x, ids, gates, w_gate, w_up, w_down)}) != 1:
        raise ValueError("moe_decode: inputs lie on different devices")
    if activation != "silu":
        raise ValueError(f"moe_decode takes silu experts, got {activation!r}")
    if not x.is_cuda:
        return moe_decode_ref(x, ids, gates, w_gate, w_up, w_down, (lo, hi))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"moe_decode kernel takes float32 or bfloat16, got {x.dtype}")
    vec = 16 // x.element_size()
    if B * K > MAX_SLOTS or d % vec or f % vec:
        raise ValueError(f"moe_decode kernel takes B*K <= {MAX_SLOTS} and d, f multiples of "
                         f"{vec}, got B={B}, K={K}, d={d}, f={f}")
    tensors = (x, ids, gates, w_gate, w_up, w_down)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("moe_decode kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (x, w_gate, w_up, w_down)):
        raise ValueError("moe_decode kernel needs 16-byte aligned x and experts")
    splits = -(-f // F_SPLIT)
    h = torch.empty((B * K, f), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, B * K, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = _build.library().repro_moe_decode(
        x.data_ptr(), ids.data_ptr(), gates.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), h.data_ptr(), part.data_ptr(), out.data_ptr(), B, K, d, f, F_SPLIT,
        lo, hi, _DTYPE_CODE[x.dtype], _build.stream_handle(x))
    _build.check(err, "moe_decode")
    accounting.count_launches(moe_decode, LAUNCHES)
    return out


moe_decode.launches = 0
