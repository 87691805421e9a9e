"""dump.d2h_bytes_per_node: ``DeltaDumpPipeline.d2h_bytes`` moved for the
window's dumps over the dumps that committed."""


def read(rec):
    return rec["d2h_bytes"] / len(rec["drain_ms"]) if rec["drain_ms"] else None
