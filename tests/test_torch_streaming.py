"""repro_torch.core.streaming and the slot grid against the JAX reference:
the fused chunk executor (``tcn_block`` plain version) against the JAX
``make_grid_fused`` over a ragged multi-chunk schedule (fp32 tolerance
rtol=2e-4, atol=2e-5), the per-step stream against the full forward, and
the port's own invariants bit-exact: fused == per-step scan on baked
params, and chunk-size invariance."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import streaming as js  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models import tcn as jt  # noqa: E402
from repro.sessions import state as jstate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import streaming as ts  # noqa: E402
from repro_torch.models import tcn as tt  # noqa: E402
from repro_torch.sessions import state as tstate  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(tcn_channels=(8, 8), tcn_kernel=3, tcn_in_channels=2,
             embed_dim=12, n_classes=4)


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    jcfg = j_get_config("chameleon-tcn").replace(kernel_backend="ref", **SMALL)
    cfg = get_config("chameleon-tcn").replace(**SMALL)
    params = j_build_bundle(jcfg).init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 7)
    bn = jax.tree.map(lambda a: a + jnp.asarray(
        0.05 * np.abs(rng.normal(size=a.shape)).astype(np.float32)),
        jt.tcn_empty_state(jcfg))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return (jcfg, cfg, params, bn, params_from_jax(np_tree(params), "cpu"),
            params_from_jax(np_tree(bn), "cpu"))


def _grid_leaves(states):
    """(t, [rings in block order]) of a JAX or port grid, as numpy."""
    blocks = states["blocks"]
    rings = [np.asarray(blocks[b][r]) for b in sorted(blocks)
             for r in ("ring1", "ring2")]
    return np.asarray(states["t"]), rings


def test_ring_sizes_match_reference():
    jcfg, cfg, *_ = _setup()
    assert ts.ring_sizes(cfg) == js.ring_sizes(jcfg)


@pytest.mark.parametrize("quantize", [False, True])
def test_fused_chunk_matches_reference_grid(quantize):
    jcfg, cfg, params, bn, *_ = _setup()
    _, _, fj = jt.bake_stream_params(params, bn, jcfg, quantize=quantize)
    ft = params_from_jax(jax.tree.map(np.asarray, fj), "cpu")
    S, T = 3, 7  # 7 is coprime with the ring depths: chunks straddle wraps
    run_j = jax.jit(jstate.make_grid_fused(jcfg, quantize=quantize))
    run_t = tstate.make_grid_fused(cfg, quantize=quantize, device="cpu")
    gj, gt = jstate.grid_init(jcfg, S), tstate.grid_init(cfg, S, "cpu")
    rng = np.random.default_rng(11)
    for step in range(4):
        x = rng.normal(size=(S, T, 2)).astype(np.float32)
        lens = rng.integers(0, T + 1, size=S).astype(np.int32)
        lens[step % S] = 0  # one frozen slot per chunk
        gj, ej, lj = run_j(fj, gj, jnp.asarray(x), jnp.asarray(lens))
        gt, et, lt = run_t(ft, gt, torch.tensor(x), torch.tensor(lens))
        for i in range(S):
            n = lens[i]
            np.testing.assert_allclose(et.numpy()[i, :n], np.asarray(ej)[i, :n],
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(lt.numpy()[i, :n], np.asarray(lj)[i, :n],
                                       rtol=RTOL, atol=ATOL)
        tj, rj = _grid_leaves(gj)
        tt_, rt = _grid_leaves({"t": gt["t"].numpy(), "blocks": {
            b: {r: v.numpy() for r, v in d.items()}
            for b, d in gt["blocks"].items()}})
        np.testing.assert_array_equal(tt_, tj)
        for a, b in zip(rt, rj):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_fused_equals_grid_scan_on_baked_params(quantize):
    """The port's two executors sum in the same order: on baked params
    outputs at valid positions and the end state are bit-identical."""
    _, cfg, _, _, p, bn = _setup()
    scan_p, scan_bn, fused_p = tt.bake_stream_params(p, bn, cfg,
                                                     quantize=quantize)
    S, T = 3, 7
    fused = tstate.make_grid_fused(cfg, quantize=quantize, device="cpu")
    ga, gb = tstate.grid_init(cfg, S, "cpu"), tstate.grid_init(cfg, S, "cpu")
    rng = np.random.default_rng(12)
    for step in range(3):
        x = torch.tensor(rng.normal(size=(S, T, 2)).astype(np.float32))
        lens = torch.tensor(rng.integers(0, T + 1, size=S).astype(np.int32))
        ga, ea, la = tstate.grid_scan(scan_p, scan_bn, cfg, ga, x,
                                      tstate.lengths_to_valid(lens, T),
                                      quantize=quantize)
        gb, eb, lb = fused(fused_p, gb, x, lens)
        for i in range(S):
            n = int(lens[i])
            assert torch.equal(ea[i, :n], eb[i, :n])
            assert torch.equal(la[i, :n], lb[i, :n])
        assert torch.equal(ga["t"], gb["t"])
        for b in ga["blocks"]:
            for r in ("ring1", "ring2"):
                assert torch.equal(ga["blocks"][b][r], gb["blocks"][b][r])


def test_fused_chunk_size_invariance():
    """One stream pushed in different chunkings gives the same bits."""
    _, cfg, _, _, p, bn = _setup()
    _, _, fused_p = tt.bake_stream_params(p, bn, cfg)
    fused = tstate.make_grid_fused(cfg, device="cpu")
    x = torch.tensor(np.random.default_rng(13).normal(
        size=(2, 23, 2)).astype(np.float32))
    outs = []
    for cuts in ([23], [1] * 23, [4, 4, 4, 4, 4, 3], [16, 7]):
        g = tstate.grid_init(cfg, 2, "cpu")
        embs, off = [], 0
        for c in cuts:
            g, e, _ = fused(fused_p, g, x[:, off:off + c].contiguous(),
                            torch.full((2,), c, dtype=torch.int32))
            embs.append(e)
            off += c
        outs.append(torch.cat(embs, dim=1))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_per_step_stream_matches_forward_and_reference():
    jcfg, cfg, params, bn, p, bnt = _setup()
    T = 12
    x = np.random.default_rng(14).normal(size=(T, 2)).astype(np.float32)
    st = ts.stream_init_single(cfg, "cpu")
    st, embs, logits = ts.stream_scan_single(
        p, bnt, cfg, st, torch.tensor(x), torch.ones(T, dtype=torch.bool))
    assert int(st["t"]) == T
    ef, lf = tt.tcn_forward(p, bnt, cfg, torch.tensor(x)[None])
    np.testing.assert_allclose(embs[-1].numpy(), ef[0].numpy(), rtol=RTOL, atol=ATOL)
    sj = js.stream_init_single(jcfg)
    _, ej, lj = js.stream_scan_single(params, bn, jcfg, sj, jnp.asarray(x),
                                      jnp.ones(T, bool))
    np.testing.assert_allclose(embs.numpy(), np.asarray(ej), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)


def test_batched_stream_with_shared_counter_matches_forward():
    """stream_init + stream_step (one counter for the batch) reproduce the
    full forward's last-step embedding for every row."""
    _, cfg, _, _, p, bnt = _setup()
    x = torch.tensor(np.random.default_rng(16).normal(
        size=(3, 10, 2)).astype(np.float32))
    st = ts.stream_init(cfg, 3, "cpu")
    for i in range(10):
        st, emb, logits = ts.stream_step(p, bnt, cfg, st, x[:, i])
    assert int(st["t"]) == 10
    ef, lf = tt.tcn_forward(p, bnt, cfg, x)
    np.testing.assert_allclose(emb.numpy(), ef.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), lf.numpy(), rtol=RTOL, atol=ATOL)


def test_invalid_steps_freeze_state():
    _, cfg, _, _, p, bnt = _setup()
    x = torch.tensor(np.random.default_rng(15).normal(size=(6, 2)).astype(np.float32))
    st0 = ts.stream_init_single(cfg, "cpu")
    a, _, _ = ts.stream_scan_single(p, bnt, cfg, st0, x[:3], torch.ones(3, dtype=torch.bool))
    b, _, _ = ts.stream_scan_single(
        p, bnt, cfg, st0, x, torch.tensor([True] * 3 + [False] * 3))
    assert torch.equal(a["t"], b["t"])
    for blk in a["blocks"]:
        for r in ("ring1", "ring2"):
            assert torch.equal(a["blocks"][blk][r], b["blocks"][blk][r])
