"""Serving under expert parallelism: the port's ``Engine`` with every call
inside ``activation_sharding(..., mesh=...)``, so each MoE layer runs the
expert-parallel path over a logical mesh, against the same engine with no
context (the unsharded port engine, which ``test_torch_serve_families.py``
holds against the JAX package's ``Engine``).

``qwen3-moe-30b-a3b-tiny`` (4 experts, top-2, capacity factor 4.0) drops
no assignment, so both decode the same tokens with logits within 1e-5.
The run: a prefill, decode steps, a delta checkpoint, a fast fork, a
template eviction and a slow restore, each restored session decoding
exactly what the fork decodes.  (1, 4) puts one expert on each "model"
rank; (2, 2) also all-gathers each rank's expert weights over "data"
(FSDP) and, with one session a batch, keeps the batch unsharded
(``dp=()``): a batch of one does not split over two data ranks.
"""
import pytest

pytest.importorskip("torch")

import contextlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import DeltaCR, DumpPolicy
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import activation_sharding
from repro_torch.launch.mesh import make_logical_mesh
from repro_torch.models import Model
from repro_torch.serve import Engine, PagedSession, PagePool

torch.set_num_threads(1)

CFG = "qwen3-moe-30b-a3b-tiny"
PROMPT = [5, 17, 3, 99, 42, 7, 250, 11, 64]


def _serve(mesh_shape, dp):
    """Tokens and logits of the run, and the collective calls it made."""
    cfg = get_config(CFG)
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    pool = PagePool(cfg, num_pages=64, page_size=4, max_pages_per_session=16, device="cpu")
    eng = Engine(model, pool)
    ctx = contextlib.nullcontext()
    if mesh_shape is not None:
        mesh = make_logical_mesh(mesh_shape, device="cpu")
        ctx = activation_sharding(dp=dp, model="model", attn_shard=cfg.attn_shard, mesh=mesh)
    cr = DeltaCR(template_pool_size=1, async_warm=False, policy=DumpPolicy(mode="delta"),
                 restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    out = {"logits": []}
    col.reset_ledger()
    try:
        with ctx:
            trunk = eng.new_session(PROMPT)
            out["logits"].append(trunk.extras["last_logits"])
            for _ in range(3):
                eng.step([trunk])
                out["logits"].append(trunk.extras["last_logits"])
            cr.checkpoint(trunk, 1, None)
            eng.step([trunk])
            cr.checkpoint(trunk, 2, 1)
            cr.wait_dumps()
            out["image_mode"] = cr.dump_future(2).result().mode
            fork, path = cr.restore(2)
            assert path == "fast"
            assert cr.evict_template(2)
            slow, path = cr.restore(2)
            assert path == "slow"
            assert slow.tokens == fork.tokens
            for _ in range(3):
                eng.step([fork])
                eng.step([slow])
                np.testing.assert_array_equal(fork.extras["last_logits"],
                                              slow.extras["last_logits"])
                out["logits"].append(fork.extras["last_logits"])
            assert slow.tokens == fork.tokens
            eng.step([trunk, fork])                # one batched step, B = 2
            out["logits"] += [trunk.extras["last_logits"], fork.extras["last_logits"]]
            out["tokens"] = (list(trunk.tokens), list(fork.tokens))
            for s in (trunk, fork, slow):
                s.release()
    finally:
        cr.shutdown()
    out["calls"] = col.ledger()["calls"]
    out["gathered"] = sum(col.ledger()["received"].get("all_gather", {}).values())
    return out


@pytest.fixture(scope="module")
def unsharded():
    return _serve(None, ())


@pytest.mark.parametrize("mesh_shape,dp", [((1, 4), ("data",)), ((2, 2), ())],
                         ids=["1x4", "2x2"])
def test_engine_under_ep_decodes_the_unsharded_tokens(unsharded, mesh_shape, dp):
    got = _serve(mesh_shape, dp)
    # every MoE layer call went through the EP path: two all_to_alls each
    # (1 layer; 1 prefill, 4 trunk steps, 3 fork and 3 slow steps, 1 batched)
    calls = 1 + 4 + 3 + 3 + 1
    assert got["calls"]["all_to_all"] == 2 * calls
    assert got["calls"]["all_gather"] == 4 * calls     # router and three expert weights
    assert (got["gathered"] > 0) == (mesh_shape == (2, 2))   # a gather over "data" of 1 moves nothing
    assert unsharded["calls"] == {}
    assert got["tokens"] == unsharded["tokens"]
    assert got["image_mode"] == unsharded["image_mode"] == "delta"
    assert len(got["logits"]) == len(unsharded["logits"])
    for a, b in zip(got["logits"], unsharded["logits"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
