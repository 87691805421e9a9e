"""The port's three dump modes, forced, against the JAX package.

The port keeps ``delta`` (its default), ``digest`` and ``legacy``; it has
no adaptive selector, no straight-copy mode and no dirty-fraction hint.
Under each forced mode, the same writes through both packages give the
same images entry for entry: chunk ids, chunk digests, landed mode, dirtied
chunks, key statistics and chunk-store statistics.  Under every mode the
images decode to the bytes the default policy's images decode to.  The
dirty-key tracking that clean-key reuse rests on is held directly for each
state that tracks writes.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro.core import CowArrayState as JCowArrayState
from repro.core import DeltaCR as JDeltaCR
from repro.core.chunk_store import chunk_digest as j_chunk_digest
from repro.core.policy import DumpPolicy as JDumpPolicy
from repro_torch.configs import get_config
from repro_torch.core import (
    CowArrayState,
    CowTensorState,
    DeltaCR,
    DumpPolicy,
    state_from_numpy,
)
from repro_torch.core.chunk_store import chunk_digest
from repro_torch.core.deltafs import host_bytes, read_meta_array
from repro_torch.dist.shard_dump import ShardedTensorState
from repro_torch.serve import PagePool, PagedSession
from test_torch_deltacr import CHUNK, JnpGridState, _image_view, t_write_bytes
from test_torch_kvcache import World, _script

MODES = ("delta", "digest", "legacy")
STEPS = 5


def _arrays(rng):
    return {
        "heap": rng.standard_normal(1500).astype(np.float32),    # ragged tail
        "ids": rng.integers(0, 1 << 30, 700, dtype=np.int32),
        "tiny": rng.integers(0, 9, 5, dtype=np.int64),            # sub-chunk
    }


def _writes(seed, sizes):
    """Seeded byte writes per checkpoint into tensors of ``sizes`` bytes:
    mostly a few bytes, sometimes a whole tensor."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(STEPS):
        step = []
        for _ in range(int(rng.integers(1, 4))):
            key = sorted(sizes)[int(rng.integers(len(sizes)))]
            n = sizes[key] if rng.random() < 0.2 else int(rng.integers(1, 48))
            n = min(n, sizes[key])
            lo = int(rng.integers(0, sizes[key] - n + 1))
            step.append((key, lo, rng.integers(0, 256, n, dtype=np.uint8)))
        steps.append(step)
    return steps


def _host_write(state, key, lo, data):
    def put(a):
        a.reshape(-1).view(np.uint8)[lo : lo + len(data)] = data

    state.mutate(key, put)


def _copy(payload):
    return {k: np.array(v, copy=True) for k, v in payload.items()}


#: per state kind: the reference's state and writer, then the port's
KINDS = {
    "CowArrayState": (
        lambda a: JCowArrayState(_copy(a)), _host_write,
        lambda a: CowArrayState(_copy(a)), _host_write,
    ),
    "CowTensorState": (
        JnpGridState, lambda s, k, lo, d: s.write_bytes(k, lo, d),
        lambda a: state_from_numpy(a, device="cpu"), t_write_bytes,
    ),
}


def _chain(cr, state, write, steps):
    """Checkpoint, then per step its writes and a checkpoint on the
    previous one; every dump lands before the next."""
    cr.checkpoint(state, 1, None)
    cr.wait_dumps()
    for c, step in enumerate(steps, start=2):
        for key, lo, data in step:
            write(state, key, lo, data)
        cr.checkpoint(state, c, c - 1)
        cr.wait_dumps()
    return list(range(1, STEPS + 2))


def _record(cr, ckpts, digest):
    """What the packages must agree on: each image's entries (chunk ids and
    chunk digests), mode and dirtied chunks, then the key and store
    statistics."""
    images = []
    for c in ckpts:
        img = cr.dump_future(c).result()
        ids = {k: tuple(m.chunk_ids) for k, m in img.entries.items()}
        images.append((ids, _image_view(cr.store, img, digest), img.mode, img.dirtied_chunks))
    s = cr.stats
    return images, (s.kernel_keys, s.full_keys, s.clean_keys, s.dumps), dict(vars(cr.store.stats))


def _decoded(cr, ckpts):
    """Every image's entries as bytes (layouts differ between modes)."""
    return [
        {k: host_bytes(read_meta_array(cr.store, m)).tobytes()
         for k, m in cr.dump_future(c).result().entries.items()}
        for c in ckpts
    ]


def _paged_run(world, ops):
    """The paged session's write/checkpoint script, on one chain: the
    landed images' records, then their decoded bytes."""
    cr, live, ckpts = world.cr, world.Session(world.pool), []
    for op in ops:
        if op[0] == "write":
            world.write(live, op[1])
        elif op[0] == "ckpt":
            c = len(ckpts) + 1
            cr.checkpoint(live, c, ckpts[-1] if ckpts else None)
            cr.wait_dumps()
            ckpts.append(c)
    digest = j_chunk_digest if world.pkg == "jax" else chunk_digest
    out = _record(cr, ckpts, digest), _decoded(cr, ckpts)
    live.release()
    cr.shutdown()
    return out


@pytest.mark.parametrize("state", ["CowArrayState", "CowTensorState", "PagedSession"])
@pytest.mark.parametrize("mode", MODES)
def test_forced_modes_bit_identical(mode, state):
    seed = MODES.index(mode) + 7
    if state == "PagedSession":
        ops = [op for op in _script(seed) if op[0] in ("write", "ckpt")]
        (want, _), (got, got_bytes) = (
            _paged_run(World("jax", "float32", mode), ops),
            _paged_run(World("torch", "float32", mode), ops),
        )
        _, default_bytes = _paged_run(World("torch", "float32", "delta"), ops)
    else:
        j_state, j_write, t_state, t_write = KINDS[state]
        arrays = _arrays(np.random.default_rng(seed))
        steps = _writes(seed, {k: v.nbytes for k, v in arrays.items()})
        runs = {}
        for name, cr, st, write, digest in (
            ("jax", JDeltaCR(chunk_bytes=CHUNK, policy=JDumpPolicy(mode=mode)),
             j_state(arrays), j_write, j_chunk_digest),
            ("torch", DeltaCR(chunk_bytes=CHUNK, policy=DumpPolicy(mode=mode)),
             t_state(arrays), t_write, chunk_digest),
            ("default", DeltaCR(chunk_bytes=CHUNK), t_state(arrays), t_write, chunk_digest),
        ):
            ckpts = _chain(cr, st, write, steps)
            runs[name] = (_record(cr, ckpts, digest), _decoded(cr, ckpts))
            cr.shutdown()
        want, (got, got_bytes), (_, default_bytes) = runs["jax"][0], runs["torch"], runs["default"]
    assert got[0] == want[0], "images"
    assert got[1] == want[1], "key statistics"
    assert got[2] == want[2], "chunk-store statistics"
    assert {img[2] for img in got[0]} == {mode}
    assert got_bytes == default_bytes


# ---------------------------------------------------------------------------
# dirty-key tracking, for every state that tracks its writes
# ---------------------------------------------------------------------------
def _tracked(kind):
    """A state of ``kind`` with keys ``a`` and ``b``, and a writer of one key."""
    a = np.arange(512, dtype=np.float32)
    b = np.ones(512, np.float32)
    if kind == "CowArrayState":
        s = CowArrayState({"a": a, "b": b})
        return s, lambda k: s.mutate(k, lambda x: x.__setitem__(0, 5.0)), "{}"
    if kind == "CowTensorState":
        s = CowTensorState({"a": a, "b": b}, device="cpu")
        return s, lambda k: s.mutate(k, lambda x: x.__setitem__(0, 5.0)), "{}"
    if kind == "ShardedTensorState":
        s = ShardedTensorState({"a": torch.from_numpy(a), "b": torch.from_numpy(b)})
        return s, lambda k: s.set(k, s.get(k) + 1), "{}"
    pool = PagePool(get_config("olmo-1b-tiny"), num_pages=8, page_size=4,
                    max_pages_per_session=4, device="cpu")
    s = PagedSession(pool, extras={"a": a, "b": b})
    return s, lambda k: s.extras.__setitem__(k, s.extras[k] + 1), "extra/{}"


@pytest.mark.parametrize(
    "kind", ["CowArrayState", "CowTensorState", "PagedSession", "ShardedTensorState"])
def test_dirty_keys_after_writes(kind):
    """Unknown until a checkpoint marks the state clean; then exactly the
    keys written since, a fork carrying the set; unknown again once
    invalidated."""
    s, write, name = _tracked(kind)
    always = {"meta/seq_len", "meta/tokens"} if kind == "PagedSession" else set()

    def dirty(state):
        return state.delta_generation(CHUNK).dirty_keys

    assert dirty(s) is None and s.dirty_tracking_base() is None
    s.reset_dirty_tracking(3)
    assert s.dirty_tracking_base() == 3 and dirty(s) == always
    write("b")
    assert dirty(s) == always | {name.format("b")}
    f = s.fork()
    write("a")
    assert dirty(s) == always | {name.format("a"), name.format("b")}
    assert dirty(f) == always | {name.format("b")}
    s.invalidate_dirty_tracking()
    assert dirty(s) is None and s.dirty_tracking_base() is None
    f.release()
    s.release()
