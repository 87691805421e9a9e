"""kernel.moe_decode_roofline: the bytes the traced window's decode steps
need ``moe_decode`` to move (the three matrices of each distinct routed
held expert once per layer and step, and each row's activations), over
3.35 TB/s, as a share of the kernel's device time in the trace.

The experts a step read come from the program's ``engine.step`` span
(``experts_read``, ``rows``).  Their bytes come from the benchmark alone:
the family's ``decode_costs`` (``moe_expert_bytes``, ``moe_row_bytes``)
where it gives them, else the config of this metric's cell whose family's
``decode_costs`` the run recorded (jamba's, through its ``dims`` and
``period``).  None where the program ran no such kernel or recorded no
such step."""
from bench.harness import registry
from bench.harness.peaks import HBM_BYTES_PER_S
from bench.harness.program import window_run

NAME = "kernel.moe_decode_roofline"
KERNELS = ("moe_gate_up_kernel", "moe_down_kernel", "moe_combine_kernel")


def _from_config(cfg, family):
    """(an expert's bytes, a row's activation bytes over the MoE layers) of
    a family that lays its layers out by ``dims`` and ``period``."""
    if not (hasattr(family, "dims") and hasattr(family, "period")):
        return None
    k = family.dims(cfg)
    moe_layers = k["N"] * sum(ffn == "moe" for _, ffn in family.period(cfg))
    item = family.DTYPES[cfg["torch_dtype"]].itemsize
    return (3.0 * k["d"] * k["f"] * item,
            float(moe_layers * (2 * k["d"] * item + 8 * cfg["num_experts_per_tok"])))


def moe_costs(costs):
    """(an expert's bytes, a row's bytes) of the run's cell, or None."""
    if "moe_expert_bytes" in costs:
        return costs["moe_expert_bytes"], costs["moe_row_bytes"]
    metric = next((m for m in registry.benchmark_spec()["per_layer"] if m["name"] == NAME), {})
    for cell in metric.get("workloads", []):
        cfg = registry.load_json("configs", registry.load_json("workloads", cell)["config"])
        family = registry.load_module("models", cfg["family"])
        if family.decode_costs(cfg) == costs:
            return _from_config(cfg, family)
    return None


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    kernel_s = sum(s for name, s in tr["by_name"].items() if any(k in name for k in KERNELS))
    snap = window_run()
    if kernel_s <= 0 or snap is None:
        return None
    per = moe_costs(rec["costs"])
    if per is None:
        return None
    expert_bytes, row_bytes = per
    p0, p1 = tr["span_ns"]
    need = sum(s.attr["experts_read"] * expert_bytes + s.attr["rows"] * row_bytes
               for s in snap["spans"]
               if s.name == "engine.step" and s.attr and "experts_read" in s.attr
               and s.t0_ns >= p0 and s.t1_ns <= p1)
    if need <= 0:
        return None
    return 100.0 * need / HBM_BYTES_PER_S / kernel_s
