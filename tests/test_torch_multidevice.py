"""The port's services over a device mesh, on gloo ranks on the CPU.

The twin of tests/test_multidevice.py.  One spawn per world size (4, then
2, then 1), each rank running tests/_torch_mesh.py's scenarios, and the
JAX package's services on four host devices in a subprocess of their own
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, that test's
idiom).  The checks, asserted here in the parent:

  * grid leaves split 2 slots a rank at mesh (4, 1), bank leaves 2
    tenants a rank at (1, 4), both at (2, 2);
  * a chunked push (``t_chunk`` 8) with enrollment, on every mesh and
    with a paged bank, bit for bit against the port's unsharded service,
    and chunk-size invariance (``t_chunk`` 3 and 1) on the mesh;
  * every rank returns the same results;
  * a session parked on one rank resumes on another, bit for bit, and a
    spilled lot restores into a fresh meshed service;
  * LM dense decode bit for bit against unsharded, the cache still
    sharded after several dispatches, an LM park/resume across ranks, and
    ``paged=True`` with a mesh refused;
  * a checkpoint of sharded trees restores at world sizes 4 -> 2 -> 1
    with the same bits;
  * a one-rank mesh, sharded over its size-1 axes (its gathers and
    broadcasts run), is the unsharded service bit for bit;
  * against the JAX package's 4-device services on the same seeded
    inputs: the TCN service (``fused`` on both sides) at rtol 2e-4, atol
    2e-5 x max(1, max|want|); the meshed LM service's logits at fp32
    rtol 1e-4, atol 1e-5 and its tokens equal, both up to the reference's
    first top-2 margin below 1e-3.

Rendezvous through files under the test's tmp dir (no TCP port, so
parallel test workers cannot collide), one torch thread a rank, a
process-group timeout, and every spawn joined with its own timeout."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mesh as tm  # noqa: E402

SPAWN_TIMEOUT = {4: 360, 2: 180, 1: 180}
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the JAX subprocess's results (or its error), world: [each
    rank's pickle]}, from one JAX subprocess and one spawn a world size."""
    out = tmp_path_factory.mktemp("mesh")
    jax_dir = out / "jax"
    jax_dir.mkdir()
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           str(HERE)]))
    r = subprocess.run(
        [sys.executable, "-c",
         f"import _torch_mesh; _torch_mesh.jax_main({str(jax_dir)!r})"],
        env=env, capture_output=True, text=True, timeout=420)
    got = {"jax_error": None if r.returncode == 0 else r.stderr[-4000:]}
    if r.returncode == 0:
        with open(jax_dir / "jax.pkl", "rb") as f:
            got["jax"] = pickle.load(f)
    for world in (4, 2, 1):
        tm.spawn(tm.rank_main, world,
                 (str(out / f"rdv{world}"), str(out),
                  str(jax_dir) if r.returncode == 0 else None),
                 SPAWN_TIMEOUT[world])
        got[world] = []
        for rank in range(world):
            with open(out / f"w{world}_r{rank}.pkl", "rb") as f:
                got[world].append(pickle.load(f))
    got["jax_params"] = str(jax_dir / "params.npz")
    return got


def _same(a, b) -> None:
    """Two scenario results bit for bit (arrays, None, ints, lists)."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_grid_leaves_split_two_slots_a_rank(runs):
    for r in runs[4]:
        rows = r["grid_4x1"]
        assert rows and all(n == 2 and g == 8 and "Shard(dim=0)" in p
                            for n, g, p in rows), rows
    assert [r["slots_4x1"] for r in runs[4]] == [(0, 2), (2, 4), (4, 6),
                                                 (6, 8)]


def test_bank_leaves_split_two_tenants_a_rank(runs):
    for r in runs[4]:
        rows = r["bank_1x4"]
        assert len(rows) == 3 and all(n == 2 and g == 8 for n, g, _ in rows)
        assert all(p.endswith("Shard(dim=0))") for _, _, p in rows), rows
        assert all(n == 8 for n, _, _ in r["grid_1x4"])  # slots replicated
        assert all(n == 8 for n, _, _ in r["bank_4x1"])  # bank replicated


def test_two_by_two_mesh_splits_both(runs):
    for r in runs[4]:
        assert all(n == 4 for n, _, _ in r["grid_2x2"])
        assert all(n == 4 for n, _, _ in r["bank_2x2"])


# ---------------------------------------------------------------------------
# the TCN service against the unsharded one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["4x1", "1x4", "2x2"])
def test_sharded_push_matches_unsharded(runs, mesh):
    for r in runs[4]:
        _same(r[f"tcn_{mesh}"], r["tcn_plain"])
    assert any(res[2] is not None for res in runs[4][0]["tcn_plain"])


@pytest.mark.parametrize("t_chunk", [3, 1])
def test_chunk_size_invariance_on_the_mesh(runs, t_chunk):
    for r in runs[4]:
        _same(r[f"tcn_4x1_t{t_chunk}"], r["tcn_4x1"])


def test_paged_bank_on_the_mesh_matches_unsharded(runs):
    for r in runs[4]:
        _same(r["tcn_paged_4x1"], r["tcn_paged_plain"])


@pytest.mark.parametrize("entry", ["data", "model", "('data', 'model')",
                                   "None"])
def test_gather_joins_every_rank_block_in_order(runs, entry):
    """``spmd.gather`` over a (2, 2) mesh: each rank's ``local_range``
    block of a 12-long dim, gathered along dim 0 and along dim 1, is the
    whole dim in order on every rank."""
    n_blocks = {"data": 2, "model": 2, "('data', 'model')": 4, "None": 1}
    held = set()
    for r in runs[4]:
        (lo, hi), got0, got1 = r["gather_2x2"][entry]
        assert hi - lo == 12 // n_blocks[entry]
        held.add((lo, hi))
        assert got0 == got1 == list(range(12))
    assert len(held) == n_blocks[entry]


@pytest.mark.parametrize("key", ["tcn_4x1", "tcn_1x4", "tcn_2x2", "lm_4x1",
                                 "lm_2x2", "park_4x1", "lm_park_4x1",
                                 "ckpt_full"])
def test_every_rank_returns_the_same(runs, key):
    for r in runs[4][1:]:
        _same(r[key], runs[4][0][key])


def test_park_on_one_rank_resume_on_another(runs):
    for r in runs[4]:
        got = r["park_4x1"]
        assert got["before"] == 0 and got["after"] >= 2, got  # rank 0 -> 1+
        _same(got, r["park_plain"])
        _same(got["result"], r["park_never"])


def test_spill_and_restore_on_the_mesh(runs):
    """The first rank writes the lot; a fresh meshed service restores it
    and pushes on, bit for bit the unsharded service's."""
    for r in runs[4]:
        _same(r["spill_4x1"], r["spill_plain"])


# ---------------------------------------------------------------------------
# the LM service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_lm_decode_matches_unsharded(runs, mesh):
    for r in runs[4]:
        assert r[f"lm_{mesh}"] == r["lm_plain"]
        assert sum(len(t) for wave in r["lm_plain"] for t in wave) == 3 * 64


def test_lm_cache_stays_sharded_across_dispatches(runs):
    for r in runs[4]:
        rows = r["lm_cache_4x1"]
        assert rows and all(n == 2 and g == 8 for n, g, _ in rows), rows
        assert all("Shard(dim=1)" in p for _, _, p in rows)


def test_lm_park_on_one_rank_resume_on_another(runs):
    for r in runs[4]:
        got = r["lm_park_4x1"]
        assert got["before"] == 0 and got["after"] >= 2, got
        assert got == r["lm_park_plain"]
        assert got["tokens"] == r["lm_never"]


def test_paged_lm_with_a_mesh_raises(runs):
    for r in runs[4]:
        assert "paged=True does not compose with mesh=" in r["paged_raises"]


# ---------------------------------------------------------------------------
# checkpoints across world sizes, and a world of one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 1])
def test_checkpoint_restores_across_world_sizes(runs, world):
    want = runs[4][0]["ckpt_full"]
    for r in runs[world]:
        assert r["restored_step"] == (1 if world == 2 else 2)
        _same(r["restored_full"], want)
        n_states = len(runs[4][0]["grid_4x1"])
        rows = r["restored_rows"]
        assert all(n == 8 // world for n, _, _ in rows), rows
        assert len(rows) == n_states + 3 + len(runs[4][0]["lm_cache_4x1"])
    assert all(n == 2 for n, _, _ in runs[4][0]["ckpt_rows"])


@pytest.mark.parametrize("kind", ["tcn", "lm"])
def test_one_rank_mesh_is_the_unsharded_service(runs, kind):
    r = runs[1][0]
    want = {"tcn": ("data", "model"), "lm": ("data", None)}[kind]
    assert r["one_entries"][kind] == want
    _same(r[f"one_{kind}"], r[f"one_{kind}_plain"])


# ---------------------------------------------------------------------------
# against the JAX package's 4-device services
# ---------------------------------------------------------------------------

def _jax(runs):
    assert runs["jax_error"] is None, runs["jax_error"]
    return runs["jax"]


def _close(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    live = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), live)
    np.testing.assert_array_equal(got[~live], want[~live])
    if live.any():
        scale = max(1.0, float(np.abs(want[live]).max()))
        np.testing.assert_allclose(got[live], want[live], rtol=RTOL,
                                   atol=ATOL * scale)


def test_tcn_matches_the_jax_package_on_four_devices(runs):
    want = _jax(runs)["tcn"]
    for r in runs[4]:
        got = r["jax_tcn"]
        assert len(got) == len(want) == 2 * tm.N_SLOTS
        for g, w in zip(got, want):
            for a, b in zip(g[:3], w[:3]):
                assert (a is None) == (b is None)
                if a is not None:
                    _close(a, b)
            assert g[4] == w[4]  # steps


def test_lm_tokens_match_the_jax_package_on_four_devices(runs):
    ref = _jax(runs)
    for r in runs[4]:
        for i in range(tm.N_SLOTS):
            got = [t for wave in r["jax_lm"] for t in wave[i]]
            want = [t for wave in ref["lm"] for t in wave[i]]
            n = next((j for j, m in enumerate(ref["lm_margins"][i])
                      if m < 1e-3), len(want))
            assert got[:n] == want[:n], (i, n)
            assert len(got) == len(want) == 24


def _unsharded_logits(params_npz: str, streams) -> dict:
    """The port's unsharded ``decode_fn``, token by token on the
    reference's streams: {stream index: logits (generated, V)}."""
    _, _, _, lb, lp = tm._port_setup(params_npz)
    out = {}
    for i, prompt in enumerate(tm.lm_prompts()):
        toks = [t for wave in streams for t in wave[i]]
        seq = np.concatenate([prompt, toks]).astype(np.int32)
        cache = lb.empty_cache(1, tm.LM_KW["seq_cap"])
        rows = []
        with torch.no_grad():
            for j in range(len(seq) - 1):
                lg, cache = lb.decode_fn(lp, cache, {
                    "tokens": torch.from_numpy(seq[None, j:j + 1]),
                    "pos": torch.tensor([j], dtype=torch.int32)})
                if j >= len(prompt) - 1:
                    rows.append(lg[0].float().numpy())
        out[i] = np.stack(rows)
    return out


@pytest.mark.parametrize("source", ["mesh", "unsharded"])
def test_lm_logits_match_the_jax_package(runs, source):
    """Against the reference's token-by-token logits: "mesh", the logits
    of ``LMSessionService(mesh=)`` on the (4, 1) mesh, each rank's own
    lanes at every decode step, up to the step that emits the first token
    whose top-2 margin is below 1e-3 (later steps may run on other
    tokens); "unsharded", the port's ``decode_fn`` on the reference's
    streams, every step."""
    ref = _jax(runs)
    if source == "unsharded":
        got = _unsharded_logits(runs["jax_params"], ref["lm"])
    else:
        got = {}
        for r in runs[4]:
            assert not set(got) & set(r["jax_lm_logits"])  # one rank a lane
            got.update(r["jax_lm_logits"])
    assert sorted(got) == list(range(tm.N_SLOTS))
    for i in range(tm.N_SLOTS):
        want = ref["lm_logits"][i]
        assert got[i].shape == want.shape
        n = len(want) - 1 if source == "unsharded" else next(
            (j for j, m in enumerate(ref["lm_margins"][i]) if m < 1e-3),
            len(want) - 1)
        np.testing.assert_allclose(got[i][:n + 1], want[:n + 1],
                                   rtol=1e-4, atol=1e-5)
