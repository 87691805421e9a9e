"""kernel.paged_attention_roofline: the bytes the traced window's decode
steps need ``paged_attention`` to move (each position's keys and values
once per layer, a page that rows share counted once; each row's query,
output and length), over 3.35 TB/s, as a share of the kernel's device time
in the trace."""
from bench.harness.peaks import HBM_BYTES_PER_S


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    kernel_s = sum(s for name, s in tr["by_name"].items() if "paged_attention" in name)
    if kernel_s <= 0:
        return None
    p0, p1 = tr["span_ns"]
    c = rec["costs"]
    need = 0.0
    for n, t0, t1, _, info in rec["spans"]:
        if n == "engine.step" and t0 >= p0 and t1 <= p1:
            lens, positions = info
            need += positions * c["pa_bytes_per_position"] + len(lens) * c["pa_bytes_per_row"]
    if need <= 0:
        return None
    return 100.0 * need / HBM_BYTES_PER_S / kernel_s
