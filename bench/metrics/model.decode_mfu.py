"""model.decode_mfu: the decode steps' model FLOPs (2 per weight a row
meets, and attention over each row's context) over the steps' host time,
as a share of the H100's dense bf16 peak (989 TFLOP/s at 700 W; the
run's ``info.power`` gives the card's limit)."""
from bench.harness.peaks import BF16_FLOPS


def read(rec):
    c = rec["costs"]
    flops = secs = 0.0
    for n, t0, t1, _, info in rec["spans"]:
        if n != "engine.step":
            continue
        lens = info[0]
        flops += len(lens) * c["matmul_flops_per_row"] + sum(lens) * c["attn_flops_per_position"]
        secs += (t1 - t0) / 1e9
    return 100.0 * flops / secs / BF16_FLOPS if secs > 0 else None
