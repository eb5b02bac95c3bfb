"""The benchmark's plain reference against the program's plain CPU path at
a tiny size (a test may import both; the reference imports neither the
program nor the JAX package)."""

from __future__ import annotations

import ast
import json

import numpy as np
import pytest
import torch

from bench.harness.model import make_weights
from bench.reference import tcn as ref
from bench.tests._tiny import ROOT

CONFIGS = ("chameleon-tcn", "chameleon-tcn-audio")


def sizes(name: str) -> dict:
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


def test_the_reference_imports_only_torch():
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        mods = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert mods <= {"__future__", "torch"}, (path, mods)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("quantize", [False, True])
def test_served_weights_equal_the_programs_bake(name, quantize):
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import expand_weight
    from repro_torch.models.tcn import bake_stream_params

    sz = sizes(name)
    cfg = get_config(name)
    raw, bn = make_weights(sz, 5, "cpu")
    _, _, fused = bake_stream_params(raw, bn, cfg, quantize=quantize)
    served = ref.prepare(raw, bn, len(sz["tcn_channels"]), quantize=quantize)
    for i, blk in enumerate(served["blocks"]):
        for key, want in fused["blocks"][f"b{i}"].items():
            assert torch.equal(blk[key], expand_weight(want)), (i, key)
    assert torch.equal(served["head_w"], expand_weight(fused["head_w"]))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("quantize", [False, True])
def test_forward_matches_the_programs_fused_chunk(name, quantize):
    from repro_torch.configs import get_config
    from repro_torch.core.streaming import make_fused_chunk
    from repro_torch.models.tcn import bake_stream_params
    from repro_torch.sessions.state import grid_init

    sz = sizes(name)
    cfg = get_config(name)
    raw, bn = make_weights(sz, 9, "cpu")
    _, _, fused = bake_stream_params(raw, bn, cfg, quantize=quantize)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2, 48, 1)).astype(np.float32))
    grid = grid_init(cfg, 2, "cpu")
    chunk = make_fused_chunk(cfg, quantize=quantize, device="cpu",
                             inplace=True)
    embs, logits = [], []
    for a in range(0, 48, 16):  # three pushes: the rings carry across
        grid, e, lg = chunk(fused, grid, x[:, a:a + 16],
                            torch.full((2,), 16, dtype=torch.int32))
        embs.append(e)
        logits.append(lg)
    served = ref.prepare(raw, bn, len(sz["tcn_channels"]), quantize=quantize)
    e_ref, lg_ref = ref.forward(served, x, act_scale=sz["act_scale"],
                                quantize=quantize)
    torch.testing.assert_close(torch.cat(embs, 1), e_ref, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(torch.cat(logits, 1), lg_ref, rtol=1e-5,
                               atol=1e-6)


def test_bank_matches_the_programs_store():
    from repro_torch.core.protonet import (
        store_add_class,
        store_fc,
        store_init,
        store_update_class,
    )

    g = torch.Generator().manual_seed(1)
    shots = [torch.rand((5, 64), generator=g) for _ in range(3)]
    store = store_init(4, 64, "cpu")
    store = store_add_class(store, shots[0])
    store = store_add_class(store, shots[1])
    store = store_update_class(store, 0, shots[2])
    bank = ref.Bank(torch.zeros((0, 64)), [])
    bank.sums, bank.counts = [], []
    bank.enroll(0, shots[0])
    bank.enroll(1, shots[1])
    bank.enroll(0, shots[2])
    w, b = bank.fc(4)
    w_p, b_p = store_fc(store)
    torch.testing.assert_close(w, w_p, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(b, b_p, rtol=1e-6, atol=1e-7)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10 + 2 ** -12, -3.0 - 2 ** -20])
    want = torch.tensor([1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -3.0])
    assert torch.equal(ref.to_tf32(x), want)
