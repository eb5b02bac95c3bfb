"""The chunk entry of repro_torch.kernels.tcn_block (``tcn_chunk``) on the
CPU, where it runs its plain version ``kernels/ref.tcn_chunk_plain``.

At a few blocks of C=8, k=7 and d up to 8 (rings of 6..48 rows, so they
wrap within a few 16-row chunks):

  * the fused chunk executor against the JAX reference's
    ``repro.core.streaming.make_fused_chunk`` over ragged lengths that
    include 0, fp32 and quantized weights (rtol=2e-4, atol=2e-5, the
    repo's precedent for two fp32 summation orders);
  * the port's ring re-lay against the reference's ``_ring_advance``,
    exactly (it moves data, no arithmetic);
  * the rule the CUDA kernel writes the rings by — only the rows of the
    chunk's new positions, the newest position of each ring row winning —
    as a plain-tensor oracle against ``ring_advance``, exactly, for t on
    both sides of a wrap and T > n, in its functional and in-place forms;
  * the in-place call against the functional one, bit for bit, and the
    functional call leaving the caller's state as it was.
"""

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
from repro_torch.kernels.ref import (  # noqa: E402
    ordered_history,
    ring_advance,
    tcn_chunk_plain,
)
from repro_torch.kernels.tcn_block import (  # noqa: E402
    chunk_smem_bytes,
    max_chunk_len,
    tcn_chunk,
)
from repro_torch.models import tcn as tt  # noqa: E402
from repro_torch.sessions import state as tstate  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
NARROW = dict(tcn_channels=(8, 8, 8, 8), tcn_kernel=7, tcn_in_channels=2,
              embed_dim=12, n_classes=4)
S, T = 4, 16


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    jcfg = j_get_config("chameleon-tcn").replace(kernel_backend="ref", **NARROW)
    cfg = get_config("chameleon-tcn").replace(**NARROW)
    params = j_build_bundle(jcfg).init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 5)
    bn = jax.tree.map(lambda a: a + jnp.asarray(
        0.05 * np.abs(rng.normal(size=a.shape)).astype(np.float32)),
        jt.tcn_empty_state(jcfg))
    return jcfg, cfg, params, bn


def _baked(quantize):
    jcfg, cfg, params, bn = _setup()
    _, _, fj = jt.bake_stream_params(params, bn, jcfg, quantize=quantize)
    return fj, params_from_jax(jax.tree.map(np.asarray, fj), "cpu")


def _numpy_grid(g):
    return {"t": np.asarray(g["t"]), "blocks": {
        b: {r: np.asarray(v) for r, v in d.items()}
        for b, d in g["blocks"].items()}}


def _clone(g):
    return {"t": g["t"].clone(), "blocks": {
        b: {r: v.clone() for r, v in d.items()}
        for b, d in g["blocks"].items()}}


def _assert_grids_equal(a, b):
    assert torch.equal(a["t"], b["t"])
    for name in a["blocks"]:
        for r in ("ring1", "ring2"):
            assert torch.equal(a["blocks"][name][r], b["blocks"][name][r])


def test_ring_depths_span_the_chunk():
    """Block 0's rings are shorter than a chunk, the deepest longer."""
    _, cfg, *_ = _setup()
    depths = [rs["ring1"][0] for rs in ts.ring_sizes(cfg).values()]
    assert depths == [6, 12, 24, 48]
    assert depths[0] < T < depths[-1]


@pytest.mark.parametrize("quantize", [False, True])
def test_chunk_matches_reference_fused_chunk(quantize):
    jcfg, cfg, *_ = _setup()
    fj, ft = _baked(quantize)
    run_j = jax.jit(js.make_fused_chunk(jcfg, quantize=quantize))
    run_t = ts.make_fused_chunk(cfg, quantize=quantize, device="cpu")
    gj, gt = jstate.grid_init(jcfg, S), tstate.grid_init(cfg, S, "cpu")
    rng = np.random.default_rng(21)
    for step in range(6):  # 6 x 16 > 48: every ring wraps
        x = rng.normal(size=(S, T, 2)).astype(np.float32)
        lens = rng.integers(1, T + 1, size=S).astype(np.int32)
        lens[step % S] = 0
        lens[(step + 1) % S] = T
        gj, ej, lj = run_j(fj, gj, jnp.asarray(x), jnp.asarray(lens))
        gt, et, lt = run_t(ft, gt, torch.tensor(x), torch.tensor(lens))
        for i in range(S):
            n = lens[i]
            np.testing.assert_allclose(et.numpy()[i, :n], np.asarray(ej)[i, :n],
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(lt.numpy()[i, :n], np.asarray(lj)[i, :n],
                                       rtol=RTOL, atol=ATOL)
        want, got = _numpy_grid(gj), _numpy_grid(gt)
        np.testing.assert_array_equal(got["t"], want["t"])
        for b in want["blocks"]:
            for r in ("ring1", "ring2"):
                np.testing.assert_allclose(got["blocks"][b][r],
                                           want["blocks"][b][r],
                                           rtol=RTOL, atol=ATOL)


def _wrap_times(n):
    """Step counters just before, at and after the first two wraps."""
    return [0, n - 1, n, n + 1, 2 * n - 1, 2 * n, 2 * n + 1]


@pytest.mark.parametrize("n,Tc", [(6, 16), (12, 5), (48, 16), (24, 1)])
def test_ring_advance_matches_reference(n, Tc):
    rng = np.random.default_rng(n + Tc)
    t = np.array(_wrap_times(n), np.int32)
    lens = np.arange(len(t), dtype=np.int32) % (Tc + 1)
    strip = rng.normal(size=(len(t), n + Tc, 3)).astype(np.float32)
    want = js._ring_advance(jnp.asarray(strip), jnp.asarray(t),
                            jnp.asarray(lens), n)
    got = ring_advance(torch.tensor(strip), torch.tensor(t),
                       torch.tensor(lens), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _write_new_rows(ring, chunk, t, lengths, *, inplace):
    """The chunk kernel's ring update as plain tensor ops.  Position p of
    the stream lives in ring row p mod n; of the positions a row can hold,
    the newest below t + L wins, and the row changes only if that position
    is in the chunk (p >= t).  The in-place form visits only the new rows,
    positions t + u for u in [max(0, L - n), L); the functional form visits
    every row and keeps the old value where nothing new landed."""
    out = ring.clone()
    n = ring.shape[1]
    for s in range(ring.shape[0]):
        ts_, L = int(t[s]), int(lengths[s])
        if inplace:
            for u in range(max(0, L - n), L):
                out[s, (ts_ + u) % n] = chunk[s, u]
            continue
        for q in range(n):
            u = (q - ts_) % n
            if u < L:
                out[s, q] = chunk[s, u + (L - 1 - u) // n * n]
    return out


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("n,Tc", [(6, 16), (12, 16), (48, 16), (6, 6),
                                  (24, 1)])
def test_new_row_rule_matches_ring_advance(n, Tc, inplace):
    rng = np.random.default_rng(3 * n + Tc)
    t = torch.tensor(_wrap_times(n) * 2, dtype=torch.int32)
    lens = torch.tensor(rng.integers(0, Tc + 1, size=len(t)), dtype=torch.int32)
    lens[0], lens[1] = 0, Tc
    ring = torch.tensor(rng.normal(size=(len(t), n, 3)).astype(np.float32))
    chunk = torch.tensor(rng.normal(size=(len(t), Tc, 3)).astype(np.float32))
    want = ring_advance(torch.cat([ordered_history(ring, t), chunk], dim=1),
                        t, lens, n)
    got = _write_new_rows(ring, chunk, t, lens, inplace=inplace)
    assert torch.equal(got, want)


@pytest.mark.parametrize("quantize", [False, True])
def test_inplace_chunk_equals_functional(quantize):
    _, cfg, *_ = _setup()
    _, ft = _baked(quantize)
    k = cfg.tcn_kernel
    rng = np.random.default_rng(31)
    grid = tstate.grid_init(cfg, S, "cpu")
    grid["t"] = torch.tensor([0, 5, 47, 100], dtype=torch.int32)
    for b in grid["blocks"].values():
        for r in b:
            b[r] = torch.tensor(rng.normal(size=b[r].shape).astype(np.float32))
    x = torch.tensor(rng.normal(size=(S, T, 2)).astype(np.float32))
    lens = torch.tensor([0, T, 3, 11], dtype=torch.int32)
    before = _clone(grid)
    new, h = tcn_chunk(ft["blocks"], grid, x, lens, k=k, quantize=quantize)
    _assert_grids_equal(grid, before)  # the functional call changed nothing
    assert torch.equal(new["t"], before["t"] + lens)
    mine = _clone(grid)
    out, h2 = tcn_chunk_plain(ft["blocks"], mine, x, lens, k=k,
                              quantize=quantize, inplace=True)
    assert out is mine
    assert torch.equal(h2, h)
    _assert_grids_equal(mine, new)


def test_chunk_length_limit():
    """The kernel's shared memory bounds T; the service's chunks fit."""
    for name, limit in (("chameleon-tcn", 313), ("chameleon-tcn-audio", 222)):
        cfg = get_config(name)
        widths = [(rs["ring1"][0], rs["ring1"][1], rs["ring2"][1],
                   rs["ring1"][1] != rs["ring2"][1])
                  for rs in ts.ring_sizes(cfg).values()]
        assert max_chunk_len(widths, cfg.tcn_kernel) == limit
        for t_chunk in (16, 160):
            assert chunk_smem_bytes(widths, t_chunk, cfg.tcn_kernel) <= 232_448


def test_service_fused_tick_updates_grid_in_place():
    """The service owns its grid: a fused tick writes into the same ring
    tensors, and its outputs equal a functional chunk's."""
    from repro_torch.models import build_tcn_bundle
    from repro_torch.sessions import StreamSessionService

    _, cfg, params, bn = _setup()
    p = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    b = params_from_jax(jax.tree.map(np.asarray, bn), "cpu")
    svc = StreamSessionService(build_tcn_bundle(cfg, "cpu"), p, b, n_slots=2,
                               t_chunk=T)
    rings = [v for d in svc.states["blocks"].values() for v in d.values()]
    t = svc.states["t"]
    sid = svc.open_session()
    x = np.random.default_rng(41).normal(size=(T, 2)).astype(np.float32)
    before = _clone(svc.states)
    out = svc.push_audio({sid: x})[sid]
    assert svc.states["t"] is t
    assert all(a is c for a, c in zip(
        rings, [v for d in svc.states["blocks"].values() for v in d.values()]))
    _, _, fp = tt.bake_stream_params(p, b, cfg)
    slot = svc.sched.slot_of[sid]
    lens = torch.zeros(2, dtype=torch.int32)
    lens[slot] = T
    xg = torch.zeros((2, T, 2))
    xg[slot] = torch.tensor(x)
    new, emb, _ = ts.make_fused_chunk(cfg, device="cpu")(fp, before, xg, lens)
    assert torch.equal(torch.tensor(out["emb"]), emb[slot])
    _assert_grids_equal(svc.states, new)
