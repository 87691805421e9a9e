"""Rehearsal of ``chip_smoke.py`` phase 11 on the CPU at a tiny size.

11a: the C/R cell as a ``ShardedTensorState`` on a (4, 2) logical mesh —
turns with a checkpoint after each, every dump gather-free with each rank's
row bytes equal to its parts' dirty tiles, the first turns' images equal to
the (1, 1) layout's, the last image's digests equal to blake2b over the
port's ``array_to_grid`` rows, a fast rollback and slow restores onto (4, 2)
and (2, 4) byte-identical to device clones, and the dump after the restore
on the per-part kernel plans.  11b: serving qwen3-14b-tiny from a pool laid
over (4, 2) ranks — tiled KV images, no gather, zero-copy forks, and a slow
restore decoding exactly what a fast fork decodes, then a checkpoint after
the session gains a page (another tile plan).  Kernel launch counts
are card-only; the card runs the same functions at full width.
"""
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def test_phase11a_rehearsal():
    out = cs.run_shard_path(
        "cpu", layers=2, kv_heads=8, head_dim=16, session_tokens=256, prefix_tokens=128,
        tokens_per_turn=8, heap_bytes=64 << 10, turns=4, chunk_bytes=1024, check_turns=2,
    )
    assert out["mesh"] == [4, 2]
    assert len(out["turns"]) == 4
    for row in out["turns"]:
        assert row["kv_ranks"] == [4, 5]          # tokens 128-159 sit on data coordinate 2
        assert row["heap_ranks"] and set(row["heap_ranks"]) <= {0, 1}
        assert row["row_bytes"] > 0 and row["d2h_bytes"] == 0    # no card: no device bytes
    post = out["post_restore_dump"]
    assert post["dirty_parts"] > 0 and post["shard_parts"] == 2 * 2 * 8 + 2
    assert out["sharded_dumps"] == 4 + 1 + 1


def test_phase11b_rehearsal():
    out = cs.run_sharded_serving_path(
        "cpu", config="qwen3-14b-tiny", num_pages=64, page_size=4, max_pages=16,
        prompt_len=9, steps=2, forks=3, fork_steps=2, slow_steps=2, chunk_bytes=128,
    )
    assert out["mesh"] == [4, 2] and out["pages"] == 4
    assert out["dirty_tiles_c2"] > 0 and out["decode_tokens_compared"] == 2
    parts = out["slow_restore_parts"]
    assert parts and sum(n for _tiles, _bytes, n in parts) == out["dirty_tiles_c2"]
    assert all(0 < n <= tiles for tiles, _bytes, n in parts)
    # c3 follows a new page: another plan, so the whole session's K/V drains
    assert out["c3_pages"] == 5 and out["kv_bytes_c3"] > 0
