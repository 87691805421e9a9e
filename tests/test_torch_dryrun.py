"""The port's multi-pod dry run against the JAX package's.

(a) The per-rank argument bytes of every unskipped (arch × shape) cell on
both production meshes against the reference's ``build_step`` (the sum of
its arguments' ``sharding.shard_shape`` bytes); (b) the two compiled
``decode_32k`` cells' argument, alias and output bytes against the
reference's ``memory_analysis()``; (c) the skip records.

The reference runs in one subprocess with 512 host devices.  Its
``make_production_mesh`` builds the mesh with ``jax.make_mesh``, whose axes
are ``Explicit`` under JAX 0.9, and its steps then raise
``ShardingTypeError`` before anything is lowered; the subprocess builds the
same meshes with ``Auto`` axes instead.  The JAX package is unchanged."""
import pytest

pytest.importorskip("torch")

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.configs import arch_names, get_config
from repro_torch.launch import dryrun

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s.name, mp) for a in arch_names() for s in get_config(a).shapes if not s.skip
         for mp in (False, True)]
SKIPPED = [(a, s.name) for a in arch_names() for s in get_config(a).shapes if s.skip]
COMPILED = (("olmo-1b", "decode_32k"), ("qwen3-14b", "decode_32k"))
MESHES = {mp: dryrun.mesh_for(mp) for mp in (False, True)}
# XLA's output buffer includes its output tuple: one 8-byte pointer per leaf
TUPLE_POINTER_BYTES = 8

REF_SCRIPT = r"""
import json, sys
import jax
import numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import arch_names, get_config
from repro.launch import dryrun as D


def mesh(multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes,
                axis_types=(AxisType.Auto,) * len(shape))


D.make_production_mesh = mesh
meshes = {False: mesh(False), True: mesh(True)}
out = {"args": {}, "cells": {}, "skips": []}
for arch in arch_names():
    for shape in get_config(arch).shapes:
        if shape.skip:
            out["skips"].append(D.run_cell(arch, shape.name))
            continue
        for mp in (False, True):
            _, args, _, _ = D.build_step(get_config(arch), shape, meshes[mp])
            out["args"][f"{arch}|{shape.name}|{int(mp)}"] = sum(
                int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
                for x in jax.tree.leaves(args))
for arch, shape_name in json.loads(sys.argv[1]):
    rec = D.run_cell(arch, shape_name)
    cfg = get_config(arch)
    _, _, _, out_sh = D.build_step(cfg, cfg.shape(shape_name), meshes[False])
    rec["n_outputs"] = len(jax.tree.leaves(out_sh))
    out["cells"][f"{arch}|{shape_name}"] = rec
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(COMPILED), str(path)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


def test_the_cells_are_the_reference_s(reference):
    assert len(CELLS) == 66 and len(SKIPPED) == 7
    assert sorted(reference["args"]) == sorted(f"{a}|{s}|{int(mp)}" for a, s, mp in CELLS)


@pytest.mark.parametrize("arch,shape_name,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'2x16x16' if mp else '16x16'}" for a, s, mp in CELLS])
def test_argument_bytes_equal_the_reference(reference, arch, shape_name, multi_pod):
    """No trace, no compile: the stand-ins' per-rank bytes."""
    cfg = get_config(arch)
    _, args, _, _ = dryrun.build_step(cfg, cfg.shape(shape_name), MESHES[multi_pod])
    got = sum(a.shard_bytes for a in dryrun.leaves(args))
    assert got == reference["args"][f"{arch}|{shape_name}|{int(multi_pod)}"]


@pytest.mark.parametrize("arch,shape_name", COMPILED)
def test_compiled_cells_memory_equals_the_reference(reference, arch, shape_name):
    """Argument and alias bytes equal XLA's ``memory_analysis()``; output
    bytes equal it but for XLA's output tuple, 8 bytes a leaf (the logits
    and each cache leaf)."""
    ref = reference["cells"][f"{arch}|{shape_name}"]
    rec = dryrun.run_cell(arch, shape_name)
    assert set(rec) == set(ref) - {"n_outputs"}
    mem, want = rec["memory"], ref["memory"]
    assert mem["argument_bytes"] == want["argument_bytes"]
    assert mem["alias_bytes"] == want["alias_bytes"]
    cfg = get_config(arch)
    _, _, _, (logits_sh, cache_sh) = dryrun.build_step(cfg, cfg.shape(shape_name), MESHES[False])
    n_out = 1 + len(dryrun.leaves(cache_sh))
    assert n_out == ref["n_outputs"]
    assert mem["output_bytes"] + TUPLE_POINTER_BYTES * n_out == want["output_bytes"]
    assert mem["temp_bytes"] is None and mem["generated_code_bytes"] is None
    for key in ("arch", "shape", "mesh", "kind", "status", "n_devices", "param_count",
                "active_param_count", "microbatches"):
        assert rec[key] == ref[key], key
    assert rec["compile_s"] is None and rec["bytes_accessed"] is None
    assert rec["flops"] > 0 and rec["lower_s"] >= 0
    coll = rec["collectives"]
    assert set(coll["bytes_by_op"]) == set(ref["collectives"]["bytes_by_op"])
    assert set(coll["counts_by_op"]) == set(ref["collectives"]["counts_by_op"])
    assert coll["total_bytes"] == 0      # a dense model: no explicit collective
    if arch == "olmo-1b":
        assert (mem["argument_bytes"], mem["alias_bytes"], want["output_bytes"]) == (
            2_164_541_504, 2_147_483_680, 2_147_584_320)


@pytest.mark.parametrize("arch,shape_name", SKIPPED, ids=[f"{a}-{s}" for a, s in SKIPPED])
def test_skip_records_equal_the_reference(reference, arch, shape_name):
    want = [r for r in reference["skips"] if (r["arch"], r["shape"]) == (arch, shape_name)]
    assert [dryrun.run_cell(arch, shape_name)] == want
