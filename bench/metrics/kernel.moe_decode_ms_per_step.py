"""kernel.moe_decode_ms_per_step: the decode MoE kernels' device time in
the trace (``moe_decode``'s three launches in every MoE layer) over the
decode steps that ran inside the traced interval.  None where the program
ran no such kernel."""
KERNELS = ("moe_gate_up_kernel", "moe_down_kernel", "moe_combine_kernel")


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    kernel_s = sum(s for name, s in tr["by_name"].items() if any(k in name for k in KERNELS))
    p0, p1 = tr["span_ns"]
    steps = sum(1 for n, t0, t1, _, _ in rec["spans"] if n == "engine.step" and t0 >= p0 and t1 <= p1)
    if kernel_s <= 0 or not steps:
        return None
    return 1e3 * kernel_s / steps
