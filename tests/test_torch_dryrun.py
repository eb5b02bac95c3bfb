"""``launch/dryrun.py`` and ``utils/hlo.py`` of the port.

The dry-run runs in a subprocess, as the reference's
``test_mini_dryrun_subprocess`` runs it: ``--mesh 2x2 --smoke --device
cpu`` for the reference test's three cells and ``--mesh 2x2x1`` for one,
over a fake process group of 4 ranks, and one production cell at full
width (olmo-1b ``train_4k`` on the 16 x 16 world of 256 ranks) in a
subprocess of its own with a 120 s limit.  Each record is held against
the reference: its keys (read from the reference's ``lower_cell``), the
mesh fields, the analytic fields equal to the JAX package's
``count_cell`` (no compile), and the argument bytes per device equal to
the blocks of the reference's ``param_pspecs`` / ``train_state_pspecs``
/ ``batch_pspecs`` / ``cache_pspecs`` on a fake mesh, in plain
arithmetic, and a peak of temporaries measured; a train cell's collectives hold the FSDP all-gathers and a
reduce of the gradients.  ``collective_bytes`` and
``parse_cost_analysis`` are held to the reference parser's accounting
on hand-made records."""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.analytic import count_cell as j_count_cell  # noqa: E402
from repro.launch.specs import batch_pspecs as j_batch_pspecs  # noqa: E402
from repro.launch.specs import cache_pspecs as j_cache_pspecs  # noqa: E402
from repro.launch.specs import train_state_pspecs as j_ts_pspecs  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.sharding.rules import DEFAULT_RULES as J_RULES  # noqa: E402
from repro.sharding.rules import param_pspecs as j_param_pspecs  # noqa: E402
from repro.sharding.rules import resolve_rules as j_resolve  # noqa: E402
from repro.training.optim import adamw as j_adamw  # noqa: E402
from repro_torch.utils.hlo import (  # noqa: E402
    collective_bytes,
    parse_cost_analysis,
)

ROOT = Path(__file__).resolve().parent.parent
CELLS = [("olmo-1b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"),
         ("rwkv6-1.6b", "long_500k")]
OPCODES = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
           "collective-permute"}

SUBPROC = """
from repro_torch.launch import dryrun
for mesh, arch, shape, smoke in {runs!r}:
    dryrun.main(["--mesh", mesh, "--arch", arch, "--shape", shape,
                 "--out", {out!r}, "--force", "--device", "cpu"]
                + (["--smoke"] if smoke else []))
"""


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _dryrun(tmp_path, runs, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = SUBPROC.format(runs=runs, out=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return {tuple(f[:-5].split("__")[:3]): json.loads((tmp_path / f)
                                                      .read_text())
            for f in os.listdir(tmp_path) if f.endswith(".json")}


@pytest.fixture(scope="module")
def smoke_records(tmp_path_factory):
    runs = [("2x2", a, s, True) for a, s in CELLS] \
        + [("2x2x1", "olmo-1b", "train_4k", True)]
    return _dryrun(tmp_path_factory.mktemp("dryrun"), runs, 300)


def _reference_keys() -> set:
    """The keys of the record the reference's ``lower_cell`` builds."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) == "rec":
            return {k.value for k in node.value.keys}
    raise AssertionError("no rec literal in the reference's dryrun")


def _block_bytes(shape_dtype_tree, spec_tree, mesh) -> int:
    """Per-device bytes of a tree of ShapeDtypeStructs laid out by a tree
    of PartitionSpecs on ``mesh``."""
    from jax.sharding import PartitionSpec

    leaves = jax.tree.leaves(shape_dtype_tree)
    specs = jax.tree.leaves(spec_tree,
                            is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(specs)
    total = 0
    for a, spec in zip(leaves, specs):
        n = 1
        for i, d in enumerate(a.shape):
            e = spec[i] if i < len(spec) else None
            axes = () if e is None else (e,) if isinstance(e, str) else e
            n *= d // math.prod(mesh.shape[x] for x in axes)
        total += n * np.dtype(a.dtype).itemsize
    return total


def _reference_argument_bytes(arch, shape, dims, smoke) -> int:
    """The per-device bytes of the reference's step arguments on a fake
    mesh of ``dims``: params, then the train state (optimizer moments and
    steps) or the cache, and the batch."""
    axes = ("pod", "data", "model")[-len(dims):]
    mesh = FakeMesh(dict(zip(axes, dims)))
    cfg = j_get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    jb = j_build_bundle(cfg)
    s = J_SHAPES[shape]
    pspecs = j_param_pspecs(jb.param_defs, j_resolve(J_RULES, mesh), mesh)
    aparams = jb.abstract_params()
    ispecs = jb.input_specs(shape)
    total = _block_bytes(ispecs, j_batch_pspecs(cfg, ispecs, mesh), mesh)
    if s.kind == "train":
        aopt = jax.eval_shape(j_adamw(1e-4)[0], aparams)
        st = j_ts_pspecs(pspecs, aopt)
        total += _block_bytes(aparams, pspecs, mesh)
        total += _block_bytes((aopt.step, aopt.mu, aopt.nu),
                              (st.opt_state.step, st.opt_state.mu,
                               st.opt_state.nu), mesh)
        total += 4  # the state's step
        return total
    total += _block_bytes(aparams, pspecs, mesh)
    if s.kind == "decode":
        acache = jb.cache_specs(s.global_batch, s.seq_len)
        total += _block_bytes(acache, j_cache_pspecs(cfg, acache, mesh),
                              mesh)
    return total


def _check_record(rec, arch, shape, dims, smoke):
    s = J_SHAPES[shape]
    assert set(rec) == _reference_keys()
    assert rec["n_chips"] == math.prod(dims)
    assert rec["mesh"] == list(dims)
    assert rec["axes"] == list(("pod", "data", "model")[-len(dims):])
    assert (rec["kind"], rec["seq_len"], rec["global_batch"]) == \
        (s.kind, s.seq_len, s.global_batch)
    cfg = j_get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    ana = j_count_cell(cfg, j_build_bundle(cfg).param_defs, shape)
    assert (rec["flops_global_analytic"], rec["bytes_global_analytic"],
            rec["model_flops"], rec["n_params"], rec["n_params_active"]) \
        == (ana.flops_global, ana.bytes_global, ana.model_flops,
            ana.n_params, ana.n_params_active)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        _reference_argument_bytes(arch, shape, dims, smoke)
    assert rec["memory_analysis"]["output_size_in_bytes"] > 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["cost_analysis_flops_raw"] > 0
    assert rec["compile_s"] == 0 and rec["hlo_chars"] == 0
    assert set(rec["collective_by_type"]) <= OPCODES
    assert rec["collective_bytes_per_device"] == sum(
        rec["collective_by_type"].values())
    if s.kind == "train":  # FSDP gathers, a reduce of the gradients
        by = rec["collective_by_type"]
        assert by.get("all-gather", 0) > 0
        assert by.get("reduce-scatter", 0) + by.get("all-reduce", 0) > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_mini_dryrun_records(smoke_records, arch, shape):
    rec = smoke_records[("2x2", arch, shape)]
    _check_record(rec, arch, shape, (2, 2), True)


def test_mini_dryrun_three_axis_mesh(smoke_records):
    rec = smoke_records[("2x2x1", "olmo-1b", "train_4k")]
    _check_record(rec, "olmo-1b", "train_4k", (2, 2, 1), True)
    two = smoke_records[("2x2", "olmo-1b", "train_4k")]
    # the batch over ("pod", "data") = 4 ranks, as over "data" = 2 on 2x2
    assert rec["memory_analysis"]["argument_size_in_bytes"] < \
        two["memory_analysis"]["argument_size_in_bytes"]


def test_production_cell_at_full_width(tmp_path):
    """olmo-1b train_4k on the 16 x 16 fake world (256 ranks), at its
    published widths and depth."""
    recs = _dryrun(tmp_path, [("16x16", "olmo-1b", "train_4k", False)], 120)
    rec = recs[("16x16", "olmo-1b", "train_4k")]
    _check_record(rec, "olmo-1b", "train_4k", (16, 16), False)


# ---------------------------------------------------------------------------
# utils/hlo
# ---------------------------------------------------------------------------

def test_collective_bytes_accounting():
    recs = [
        {"opcode": "all-reduce", "results": [("f32", (256, 4096))],
         "group_size": 4},
        {"opcode": "all-gather", "results": [("bf16", (16, 8))],
         "group_size": 2},
        # a reduce-scatter's operand: its result x the group size
        {"opcode": "reduce-scatter", "results": [("f32", (64,))],
         "group_size": 16},
        # the tuple form: every result summed
        {"opcode": "all-to-all", "results": [("f32", (4, 4)),
                                             ("s32", (8,))],
         "group_size": 4},
        {"opcode": "collective-permute", "results": [("u8", (10,))],
         "group_size": 2},
        # a dtype the table does not name counts 0, and is not counted
        {"opcode": "all-reduce", "results": [("token", (1,))],
         "group_size": 2},
    ]
    got = collective_bytes(recs)
    want = {"all-reduce": 256 * 4096 * 4, "all-gather": 16 * 8 * 2,
            "reduce-scatter": 64 * 4 * 16, "all-to-all": 4 * 4 * 4 + 8 * 4,
            "collective-permute": 10}
    assert got == {"total": sum(want.values()), "by_type": want, "count": 5}
    assert collective_bytes([]) == {"total": 0, "by_type": {}, "count": 0}


def test_parse_cost_analysis():
    assert parse_cost_analysis(None) == {}
    assert parse_cost_analysis([{"flops": 3, "bytes accessed": "4"}]) == \
        {"flops": 3.0, "bytes accessed": 4.0}
    assert parse_cost_analysis([]) == {}
    assert parse_cost_analysis({"flops": 2.5, "name": "x"}) == {"flops": 2.5}
    assert parse_cost_analysis(12) == {"flops": 12.0}


def test_recorder_sees_a_redistribution():
    """A DTensor gathered over a fake world of 4 (one process) records
    its all-gathers with their result bytes."""
    code = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.utils.hlo import CollectiveRecorder, collective_bytes
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
x = DTensor.from_local(torch.zeros(4, 8), mesh, [Shard(0), Shard(1)])
with CollectiveRecorder() as rec:
    x.redistribute(mesh, [Replicate(), Replicate()])
got = collective_bytes(rec.records)
assert set(got["by_type"]) == {"all-gather"}, got
assert got["count"] == 2 and got["total"] == (8 * 16 + 8 * 8) * 4, got
dist.destroy_process_group()
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
