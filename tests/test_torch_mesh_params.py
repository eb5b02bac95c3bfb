"""The LM with its parameters placed on a mesh, on gloo ranks on the CPU.

One JAX subprocess (the reference's unsharded functions, one host
device) and one spawn of 4 and one of 2 gloo ranks
(tests/_torch_mesh_lm.py).  The checks, asserted here in the parent:

  * five cells (the reference sharding test's olmo-1b train,
    deepseek-v2-lite-16b decode and rwkv6-1.6b decode, plus zamba2-1.2b
    decode and seamless-m4t-large-v2 train; ``smoke()`` configs in fp32)
    with params placed by ``param_pspecs(DEFAULT_RULES)`` on 2x2, 4x1,
    1x4 and 2x2x1 meshes: the loss and every gradient, or every decode
    step's logits and the cache, against the JAX package's unsharded
    function and the port's, at rtol 1e-4, atol 1e-5 x max(1,
    max|want|) (sharding changes the math only by reduction order);
  * on 4x1 (FSDP and lanes only) each rank's lane of a decode bit for
    bit against the port's unsharded decode of that lane alone.  Not bit
    for bit against the unsharded decode of all four lanes: a rank's
    products run at M = 1 row where the unsharded ones run at M = 4, and
    the CPU's GEMM rounds another way at another M.  Not bit for bit in
    training: every gradient is a sum over the lane blocks
    (reduce-scatter) and the loss a sum of partial sums, in another
    order;
  * every placed leaf's local block is the reference spec's block on
    that mesh;
  * the 17 ``constrain`` sites: a recorder in place of ``constrain``
    finds the reference's sites (their functions and logical axes, read
    from its source) once each;
  * speculation over ``LMSessionService(mesh=)`` on 4 and 2 ranks, scan
    and parallel, an oracle and the n-gram drafter: tokens, acceptance
    counts and the ``spec_*`` counters (with ``device_counters``, the
    device-side accepted count too) equal to the unsharded decoder's,
    on every rank; a session parked mid-draft resumes on another rank's
    slot with the uninterrupted stream (equal call budgets);
  * ``launch/train.py --mesh 2x2`` (4 ranks, olmo-1b ``smoke()``,
    AdamW, 3 steps) against the JAX package's ``Trainer`` and the port's
    launcher without ``--mesh``, from the same params: in fp32
    activations each leaf's update (params - init) within 5e-2 of the
    update's largest entry, as tests/test_torch_lm_trainer.py holds the
    unsharded port's update, and the losses at the fp32 tolerance; in
    the launcher's bf16 activations the losses at 5e-2 x max(1, |want|)
    and each leaf's update within 5e-2 relative L2 of the unsharded
    launcher's, and no farther from the reference's than the unsharded
    launcher's is, + 5e-2 (the bf16 gradient rule of PERF.md section 2);
    a relaunch from the step-2 checkpoint bit for bit equal to the
    uninterrupted run, and ``--compress-grads`` (each rank's gradient
    blocks) near the uncompressed trajectory.

Rendezvous through files under the test's tmp dir, one torch thread a
rank, a process-group timeout, and every spawn joined with its own
timeout."""

import ast
import os
import pickle
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_mesh_lm as ml  # noqa: E402

SPAWN_TIMEOUT = {4: 300, 2: 120}
BF16_REL = 5e-2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("meshlm")
    jax_dir = out / "jax"
    jax_dir.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           str(HERE)]))
    r = subprocess.run(
        [sys.executable, "-c",
         f"import _torch_mesh_lm; _torch_mesh_lm.jax_main({str(jax_dir)!r})"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(jax_dir / "jax.pkl", "rb") as f:
        got = {"jax": pickle.load(f)}
    for world in (4, 2):
        ml.spawn(ml.rank_main, world,
                 (str(out / f"rdv{world}"), str(out), str(jax_dir)),
                 SPAWN_TIMEOUT[world])
        got[world] = []
        for rank in range(world):
            with open(out / f"w{world}_r{rank}.pkl", "rb") as f:
                got[world].append(pickle.load(f))
    return got


def _close(got, want, what):
    tol = 1e-4 * np.abs(want) + 1e-5 * max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want)
    assert np.all(err <= tol), (what, float(err.max()))


@pytest.mark.parametrize("cell", list(ml.CELLS))
def test_placed_cells_match_the_reference(runs, cell):
    want = runs["jax"][cell]
    r0 = runs[4][0]
    plain = r0[(cell, "plain")]
    assert set(plain) == set(want)
    for k in want:
        _close(plain[k], want[k], (cell, "plain", k))
    for mesh in ml.MESHES:
        got = r0[(cell, mesh)]
        assert set(got) == set(want), (cell, mesh)
        for k in want:
            _close(got[k], want[k], (cell, mesh, k))
            _close(got[k], plain[k], (cell, mesh, "port", k))
        for other in runs[4][1:]:  # every rank saw the same whole tensors
            assert all(np.array_equal(other[(cell, mesh)][k], got[k])
                       for k in got)


@pytest.mark.parametrize("cell", [c for c, (_, k) in ml.CELLS.items()
                                  if k == "decode"])
def test_4x1_lane_is_the_unsharded_lane_bit_for_bit(runs, cell):
    for rank, r in enumerate(runs[4]):
        got, lane = r[(cell, "4x1")], r[(cell, "lane")]
        for k, v in lane.items():
            mine = got[k][rank:rank + 1] if k.startswith("logits") \
                else got[k][:, rank:rank + 1]
            assert np.array_equal(mine, v), (cell, rank, k)


def _ref_blocks(cell, mesh_name):
    """{param path: local block shape} of the reference's specs."""
    from repro.configs import get_config as j_get_config
    from repro.models import build_bundle as j_build_bundle
    from repro.sharding.rules import DEFAULT_RULES as J_RULES
    from repro.sharding.rules import param_pspecs as j_param_pspecs
    from repro.sharding.rules import resolve_rules as j_resolve

    class FakeMesh:
        def __init__(self, shape):
            self.shape = shape
            self.axis_names = tuple(shape)

    dims, axes = ml.MESHES[mesh_name]
    mesh = FakeMesh(dict(zip(axes, dims)))
    jb = j_build_bundle(ml.cell_cfg(cell, j_get_config))
    specs = ml.flat(j_param_pspecs(jb.param_defs, j_resolve(J_RULES, mesh),
                                   mesh))
    defs = ml.flat(jb.param_defs)
    out = {}
    for k, d in defs.items():
        spec = tuple(specs[k]) + (None,) * (len(d.shape) - len(specs[k]))
        block = []
        for n, e in zip(d.shape, spec):
            for a in (() if e is None else (e,) if isinstance(e, str)
                      else e):
                n //= mesh.shape[a]
            block.append(n)
        out[k] = tuple(block)
    return out


@pytest.mark.parametrize("mesh", list(ml.MESHES))
def test_local_blocks_are_the_reference_specs(runs, mesh):
    for cell in ml.CELLS:
        want = _ref_blocks(cell, mesh)
        for r in runs[4]:
            assert r[(cell, mesh, "shapes")] == want, (cell, mesh)


def _reference_sites() -> Counter:
    """(enclosing function, logical axes) of every ``constrain`` call in
    the reference's models, from its source."""
    sites = Counter()
    for path in sorted((HERE.parent / "src" / "repro" / "models")
                       .glob("*.py")):
        for fn in ast.parse(path.read_text()).body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and getattr(
                        node.func, "id", None) == "constrain":
                    sites[(fn.name, ast.literal_eval(node.args[1]))] += 1
    return sites


def test_the_reference_constrain_sites_are_all_called(monkeypatch):
    """One train step of olmo-1b (swiglu, and again as gelu and relu),
    deepseek-v2-lite-16b, qwen2.5-32b (one KV head: the ``attn_kv_repeat``
    block) and seamless-m4t-large-v2 (the cross-attention block), with
    the chunked attention below the sequence length: every reference
    site is called, from the function the reference calls it in, with
    its axes, each at its own line."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle, layers, moe, transformer
    from repro_torch.training.trainer import value_and_grad

    want = _reference_sites()
    assert sum(want.values()) == 17
    funcs = {f for f, _ in want}
    seen = set()

    def record(x, axes):
        f = sys._getframe(1)
        line = (f.f_code.co_filename, f.f_lineno)
        while f is not None and f.f_code.co_name not in funcs:
            f = f.f_back
        if f is None:  # a checkpointed body recomputed in the backward
            assert line in {ln for _, _, ln in seen}, line
            return x
        seen.add((f.f_code.co_name, tuple(axes), line))
        return x

    for mod in (layers, transformer, moe):
        monkeypatch.setattr(mod, "constrain", record)
    runs = [("olmo-1b", {}), ("olmo-1b", {"mlp_type": "gelu"}),
            ("olmo-1b", {"mlp_type": "relu"}), ("deepseek-v2-lite-16b", {}),
            ("qwen2.5-32b", {"n_kv_heads": 1}),
            ("seamless-m4t-large-v2", {})]
    rng = np.random.default_rng(0)
    for arch, over in runs:
        cfg = get_config(arch).smoke().replace(
            act_dtype="float32", attn_chunk_threshold=8, **over)
        bundle = build_bundle(cfg, "cpu")
        params = bundle.init(torch.Generator().manual_seed(0))
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                               .astype(np.int32))
        batch = {"tokens": tok, "labels": tok}
        if cfg.family == "audio":
            batch["frames"] = torch.zeros((2, 16, cfg.d_model))
        value_and_grad(bundle.loss_fn, params, batch)
    got = Counter((f, a) for f, a, _ in seen)
    assert got == want


def _spec_pairs(runs, world):
    for r in runs[world]:
        for key in r:
            if key[0] == "spec" and key[1] != "plain":
                yield r, key, r[("spec", "plain") + key[2:]]


@pytest.mark.parametrize("world", [4, 2])
def test_speculation_on_a_mesh_service_is_the_unsharded(runs, world):
    pairs = list(_spec_pairs(runs, world))
    assert len(pairs) == world * 4 * len(ml.SPEC_MESHES[world])
    for r, key, plain in pairs:
        assert r[key] == plain, key
        assert plain["drafted"] > 0 and plain["counters"] == {
            "spec_drafted_total": plain["drafted"],
            "spec_accepted_total": plain["accepted"],
            "spec_device_accepted_total": plain["accepted"]}
    oracle = [p for _, k, p in pairs if k[3] == "oracle"]
    assert all(p["accepted"] == p["drafted"] for p in oracle)


@pytest.mark.parametrize("world", [4, 2])
def test_speculation_parks_and_resumes_across_ranks(runs, world):
    for r in runs[world]:
        for verify in ("scan", "parallel"):
            never = r[("park", "never", verify)]["tokens"]
            assert len(never) == 26
            assert r[("park", "plain", verify)]["tokens"] == never
            for mesh in ml.SPEC_MESHES[world]:
                got = r[("park", mesh, verify)]
                assert got["tokens"] == never, (mesh, verify)
                assert got["before"] < ml.LM_KW["n_slots"] // 2 \
                    <= got["after"]  # another rank's slot


def _updates(got, ref, init) -> np.ndarray:
    """Per leaf: the largest gap between ``got``'s update (got - init) and
    ``ref``'s over ``ref``'s largest update entry, and the relative L2
    distance of the two updates."""
    out = []
    for g, r, i in zip(got, ref, init):
        du, dg = r - i, g - i
        assert np.abs(du).max() > 0  # every leaf moved in the reference
        out.append((np.abs(dg - du).max() / max(1e-6, np.abs(du).max()),
                    np.linalg.norm(dg - du) / np.linalg.norm(du)))
    return np.array(out)


def test_launch_train_mesh_fp32_matches_the_reference(runs):
    """fp32 activations, where nothing rounds to bf16: the 2x2 launcher's
    losses at the fp32 tolerance and each leaf's update at 5e-2 of its
    largest entry, against the JAX ``Trainer`` and against the port's
    unsharded launcher (the gradients reduced over the lane blocks, the
    Partial loss reduced, AdamW on the replicated state).  A state that
    never moved, or trained on one rank's lanes only, is off by ~1."""
    want, bare = runs["jax"]["train_fp32"], runs[4][0]
    for r in runs[4]:
        hist = r["fp32_hist"]
        assert [h["step"] for h in hist] == [h["step"] for h in want["hist"]]
        for got, ref, b in zip(hist, want["hist"], bare["bare_fp32_hist"]):
            for w in (float(ref["loss"]), b["loss"]):
                assert abs(got["loss"] - w) <= 1e-4 * abs(w) + 1e-5 * max(
                    1.0, abs(w))
        for ref in (want["params"], bare["bare_fp32_params"]):
            err = _updates(r["fp32_params"], ref, want["init"])
            assert err[:, 0].max() <= BF16_REL, err[:, 0]


def test_launch_train_mesh_matches_the_reference(runs):
    """The launcher's bf16 activations: losses at 5e-2 x max(1, |want|);
    each leaf's update within 5e-2 relative L2 of the unsharded
    launcher's, and no farther from the JAX ``Trainer``'s than the
    unsharded launcher's is, + 5e-2.  Not at 5e-2 of the largest entry,
    as in fp32: AdamW's first steps move a weight by about the learning
    rate whatever its gradient's size, so a near-zero gradient that bf16
    rounding (another reduction order, another package) flips moves that
    weight by twice a step: 1.3-1.8 x the largest update, in ~0.1-1 % of
    the entries."""
    want, bare = runs["jax"]["train"], runs[4][0]
    base = _updates(bare["bare_bf16_params"], want["params"], want["init"])
    for r in runs[4]:
        hist = r["train_hist"]
        assert [h["step"] for h in hist] == [h["step"] for h in want["hist"]]
        for got, ref, b in zip(hist, want["hist"], bare["bare_bf16_hist"]):
            for w in (float(ref["loss"]), b["loss"]):
                assert abs(got["loss"] - w) <= BF16_REL * max(1.0, abs(w))
        assert all("Replicate" in p and "Shard" not in p
                   for p in r["train_placements"])
        err = _updates(r["train_params"], bare["bare_bf16_params"],
                       want["init"])
        assert err[:, 1].max() <= BF16_REL, err[:, 1]
        err = _updates(r["train_params"], want["params"], want["init"])
        assert np.all(err[:, 1] <= base[:, 1] + BF16_REL), (err, base)


def test_launch_train_mesh_compresses_each_ranks_gradient(runs):
    """``--compress-grads`` on the mesh (int8 error feedback of each
    rank's gradient blocks): the first loss is the uncompressed run's
    (the same params and batch), the last within the 0.35 that
    tests/test_torch_lm_trainer.py allows the two trajectories."""
    for r in runs[4]:
        comp, plain = r["compressed_hist"], r["train_hist"]
        assert [h["step"] for h in comp] == [h["step"] for h in plain]
        assert comp[0]["loss"] == plain[0]["loss"]
        assert np.isfinite(comp[-1]["loss"])
        assert abs(comp[-1]["loss"] - plain[-1]["loss"]) < 0.35


def test_launch_train_mesh_resumes_bit_for_bit(runs):
    for r in runs[4]:
        assert [h["step"] for h in r["resumed_hist"]] == [2]
        assert r["resumed_hist"][0]["loss"] == r["train_hist"][-1]["loss"]
        assert all(np.array_equal(a, b) for a, b in zip(
            r["resumed_params"], r["train_params"]))
