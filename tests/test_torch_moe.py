"""The MoE family of the port against the JAX reference, on the CPU: the
MoE FFN (``models/moe.py``), MLA attention (``transformer.mla_attn``, its
up-projection baseline and its absorbed decode), the deepseek-v2-lite-16b
(MLA) and moonshot-v1-16b-a3b (GQA) ``smoke()`` bundles, and an MLA
``LMSessionService``.

The same seeded numpy inputs go through both packages, params carried
across with ``convert.params_from_jax``.  Tolerances, as in
tests/test_torch_lm.py: fp32 rtol 1e-4 and atol 1e-5 x max(1, max|want|),
bf16 max|got - want| <= 5e-2 x max(1, max|want|).  Integer artifacts are
exact: ``expert_capacity``, the routing (top-k experts, ties to the lower
index) and the drop mask (which (token, choice) pairs fall past
capacity), the cache and parked-blob layouts and their bf16 bits.  The
MoE tests draw the router at unit scale, away from near-ties that fp32
rounding in either package could flip.  The bundles' greedy tokens are
equal up to the reference's first top-2 margin below 1e-3.

Inside the port, bit for bit: a lane's MoE output does not depend on the
other lanes, the baked serving tree (router kept fp32) decodes as the fp32
tree does, and an MLA service's paged cache (the 5-D ``k_rope`` leaf
pooled) equals the dense one."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.config import ArchConfig as JArchConfig  # noqa: E402
from repro.sessions import LMSessionService as JLMService  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import numpy_bits, params_from_jax  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.params import param_count  # noqa: E402
from repro_torch.sessions import LMSessionService  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402

MOE = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module, restored after it: the tiny
    ops of these narrow models gain nothing from threads, and when test
    workers oversubscribe the cores, torch's threads wait on each other
    for every op (two orders of magnitude slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_REL = 5e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def close(got, want, dtype="float32"):
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        assert float(np.abs(got - want).max(initial=0.0)) \
            <= BF16_REL * scale


def _pair(a, dtype):
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _tree_pair(tree):
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, "cpu"))


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------

def _moe_cfgs(cap=1.25, shared=1, E=8, K=2, D=32, Fe=16):
    kw = dict(n_experts=E, moe_topk=K, d_model=D, d_ff_expert=Fe,
              capacity_factor=cap, n_shared_experts=shared)
    return JArchConfig(**kw), ArchConfig(**kw)


def _moe_params(rng, cfg):
    """numpy params of ``moe_param_defs``' shapes; the router at unit
    scale (module docstring)."""
    def draw(d):
        if isinstance(d, dict):
            return {k: draw(v) for k, v in d.items()}
        return (rng.normal(size=d.shape) * d.shape[-2] ** -0.5).astype(
            np.float32)

    return draw(tmoe.moe_param_defs(cfg))


def _ref_keep(p, jcfg, x):
    """The reference's drop mask, by its own dispatch steps
    (src/repro/models/moe.py:58-86) in JAX: (B, S*K) bool."""
    B, S, _ = x.shape
    E, K = jcfg.n_experts, jcfg.moe_topk
    logits = jnp.einsum("gtd,de->gte", x.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    flat_e = top_e.reshape(B, S * K)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    counts = jax.vmap(lambda e: jnp.zeros((E,), jnp.int32).at[e].add(1))(
        flat_e)
    starts = jnp.cumsum(counts, axis=-1) - counts
    pos_sorted = jnp.arange(S * K, dtype=jnp.int32)[None] - \
        jnp.take_along_axis(starts, sorted_e, axis=-1)
    pos = jax.vmap(lambda o, ps: jnp.zeros((S * K,), jnp.int32).at[o].set(
        ps))(order, pos_sorted)
    return np.asarray(pos < jmoe.expert_capacity(S, jcfg)), \
        np.asarray(top_e)


def test_moe_param_defs_match_the_reference():
    for shared in (0, 2):
        jcfg, cfg = _moe_cfgs(shared=shared, E=6, K=3)
        got, want = tmoe.moe_param_defs(cfg), jmoe.moe_param_defs(jcfg)
        flat_g = jax.tree.leaves(got, is_leaf=lambda d: hasattr(d, "axes"))
        flat_w = jax.tree.leaves(want, is_leaf=lambda d: hasattr(d, "axes"))
        assert set(got) == set(want) and len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            assert (tuple(g.shape), tuple(g.axes), g.init, g.scale) == \
                (tuple(w.shape), tuple(w.axes), w.init, w.scale)


def test_expert_capacity_matches_the_reference():
    for S in (1, 5, 16, 64, 100, 4096):
        for E in (4, 8, 64):
            for K in (1, 2, 6):
                for f in (0.3, 1.0, 1.25, 2.0, 64.0):
                    jcfg, cfg = _moe_cfgs(cap=f, E=E, K=K)
                    c = tmoe.expert_capacity(S, cfg)
                    assert c == jmoe.expert_capacity(S, jcfg)
                    assert c % 8 == 0 and c >= 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [0.5, 64.0])
def test_moe_ffn_matches_the_reference(dtype, cap):
    """At capacity factor 0.5 tokens are dropped: the routing and the drop
    mask are the reference's exactly, ``moe_dropped`` too; y within the
    dtype's tolerance; ``moe_aux`` within fp32's."""
    jcfg, cfg = _moe_cfgs(cap=cap)
    rng = np.random.default_rng(0)
    jp, p = _tree_pair(_moe_params(rng, cfg))
    x = rng.normal(size=(3, 64, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want, jm = jmoe.moe_ffn(jp, jcfg, jx)
    got, m = tmoe.moe_ffn(p, cfg, tx)
    assert got.dtype == tx.dtype
    close(got, want, dtype)
    keep_want, e_want = _ref_keep(jp, jcfg, jx)
    _, _, top_e = tmoe.route(p, cfg, tx)
    np.testing.assert_array_equal(top_e.numpy(), e_want)
    keep = (tmoe.positions_in_expert(top_e.reshape(3, -1), cfg.n_experts)
            < tmoe.expert_capacity(64, cfg)).numpy()
    np.testing.assert_array_equal(keep, keep_want)
    assert keep.all() == (cap == 64.0)
    assert float(m["moe_dropped"]) == float(jm["moe_dropped"])
    close(m["moe_aux"], jm["moe_aux"])


def test_moe_zero_experts_give_zero_and_lanes_are_independent():
    """Zero expert weights without shared experts give y == 0 (dispatch
    and combine never alias a wrong token); a lane's output is the same
    bits whatever the other lanes hold (capacity is per sequence), fp32
    and bf16, with drops."""
    _, cfg = _moe_cfgs(cap=0.5, shared=0)
    rng = np.random.default_rng(1)
    p = params_from_jax(_moe_params(rng, cfg), "cpu")
    x = torch.from_numpy(rng.normal(size=(2, 8, cfg.d_model))
                         .astype(np.float32))
    zero = {k: torch.zeros_like(v) for k, v in p.items()}
    assert not tmoe.moe_ffn(zero, cfg, x)[0].any()
    _, cfg = _moe_cfgs(cap=0.5, shared=1)
    p = params_from_jax(_moe_params(rng, cfg), "cpu")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(size=(3, 64, cfg.d_model))
                             .astype(np.float32)).to(dtype)
        y1, m1 = tmoe.moe_ffn(p, cfg, x)
        x2 = x.clone()
        x2[1:] = torch.from_numpy(rng.normal(size=(2, 64, cfg.d_model))
                                  .astype(np.float32)).to(dtype)
        y2, _ = tmoe.moe_ffn(p, cfg, x2)
        assert float(m1["moe_dropped"]) > 0
        assert torch.equal(y1[0], y2[0])
        assert not torch.equal(y1[1], y2[1])


def test_topk_ties_take_the_lower_index():
    """Equal router columns give bit-equal probabilities: the port ranks
    the tied experts as ``jax.lax.top_k`` does, lower index first, and so
    places the same pairs in each expert's buffer."""
    jcfg, cfg = _moe_cfgs(E=8, K=3, cap=0.5)
    rng = np.random.default_rng(2)
    prm = _moe_params(rng, cfg)
    r = prm["router"]
    r[:, 5] = r[:, 1]
    r[:, 6] = r[:, 1]
    r[:, 3] = r[:, 2]
    jp, p = _tree_pair(prm)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, "float32")
    probs, _, top_e = tmoe.route(p, cfg, tx)
    assert (probs[..., 1] == probs[..., 5]).all()
    keep_want, e_want = _ref_keep(jp, jcfg, jx)
    np.testing.assert_array_equal(top_e.numpy(), e_want)
    keep = (tmoe.positions_in_expert(top_e.reshape(2, -1), 8)
            < tmoe.expert_capacity(24, cfg)).numpy()
    np.testing.assert_array_equal(keep, keep_want)
    # an explicit tie: 0.3 at experts 1, 2 and 4
    pr = torch.tensor([[0.1, 0.3, 0.3, 0.0, 0.3]])
    _, idx = torch.sort(pr, dim=-1, descending=True, stable=True)
    _, jidx = jax.lax.top_k(jnp.asarray(pr.numpy()), 3)
    np.testing.assert_array_equal(idx[:, :3].numpy(), np.asarray(jidx))


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

def _mla_setup(dtype):
    jcfg = j_get_config("deepseek-v2-lite-16b").smoke().replace(
        act_dtype=dtype)
    cfg = get_config("deepseek-v2-lite-16b").smoke().replace(act_dtype=dtype)
    rng = np.random.default_rng(3)
    defs = ttr.attn_param_defs(cfg)
    prm = {k: (rng.normal(size=d.shape) * 0.2 + (d.init == "ones"))
           .astype(np.float32) for k, d in defs.items()}
    return jcfg, cfg, _tree_pair(prm), rng


def _rope(cfg, positions):
    dim = int(cfg.qk_rope_dim * cfg.rotary_frac)
    return (jl.rope_angles(jnp.asarray(positions), dim, cfg.rope_theta),
            tl.rope_angles(torch.as_tensor(positions), dim, cfg.rope_theta))


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attn_matches_the_reference(dtype, absorb):
    """Uncached, a 5-token cached prefill, then one decode token (the
    absorbed path with ``mla_absorb``) at a shared position and at
    per-lane positions (the reference lane by lane): outputs and the
    latent cache leaves."""
    jcfg, cfg, (jp, p), rng = _mla_setup(dtype)
    jcfg, cfg = jcfg.replace(mla_absorb=absorb), cfg.replace(mla_absorb=absorb)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jr, tr = _rope(cfg, np.arange(5))
    want, _ = jtr.mla_attn(jp, jcfg, jx[:, :5], jr, None, 0)
    close(ttr.mla_attn(p, cfg, tx[:, :5], tr, None, 0), want, dtype)

    adt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    S = 8
    jc = {"c_kv": jnp.zeros((2, S, cfg.kv_lora_rank), adt),
          "k_rope": jnp.zeros((2, S, 1, cfg.qk_rope_dim), adt)}
    tc = {"c_kv": torch.zeros((2, S, cfg.kv_lora_rank), dtype=tdt),
          "k_rope": torch.zeros((2, S, 1, cfg.qk_rope_dim), dtype=tdt)}
    want, jc = jtr.mla_attn(jp, jcfg, jx[:, :5], jr, jc, jnp.int32(0))
    got = ttr.mla_attn(p, cfg, tx[:, :5], tr, tc, torch.tensor(0))
    close(got, want, dtype)
    for k in tc:
        close(tc[k], jc[k], dtype)
    jr, tr = _rope(cfg, np.arange(5, 6))
    want, jc1 = jtr.mla_attn(jp, jcfg, jx[:, 5:], jr, jc, jnp.int32(5))
    lanes = {k: v.clone() for k, v in tc.items()}
    got = ttr.mla_attn(p, cfg, tx[:, 5:], tr, tc, torch.tensor(5))
    close(got, want, dtype)
    for k in tc:
        close(tc[k], jc1[k], dtype)
    pos = np.array([5, 3], np.int32)  # lane 1 rewrites its row 3
    _, tr = _rope(cfg, pos[:, None])
    got = ttr.mla_attn(p, cfg, tx[:, 5:], tr, lanes, torch.from_numpy(pos))
    for i in range(2):
        jr_i, _ = _rope(cfg, pos[i:i + 1])
        lane = {k: v[i:i + 1] for k, v in jc.items()}
        want_i, lane = jtr.mla_attn(jp, jcfg, jx[i:i + 1, 5:], jr_i, lane,
                                    jnp.int32(pos[i]))
        close(got[i:i + 1], want_i, dtype)
        for k in lanes:
            close(lanes[k][i:i + 1], lane[k], dtype)


# ---------------------------------------------------------------------------
# the deepseek and moonshot bundles
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bundles(name: str, dtype: str):
    jcfg = j_get_config(name).smoke().replace(act_dtype=dtype)
    cfg = get_config(name).smoke().replace(act_dtype=dtype)
    assert vars(jcfg) == vars(cfg)
    jb = j_build_bundle(jcfg)
    jp = jb.init(jax.random.key(0))
    b = build_bundle(cfg, "cpu")
    return jb, jp, b, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _cache_close(got, want, dtype):
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure({k: {kk: 0 for kk in v} for k, v in got.items()})
    for part, leaves in got.items():
        for key, t in leaves.items():
            close(t, want[part][key], dtype)


def _tokens(rng, cfg, shape):
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_bundle_prefill_decode_step(name, dtype):
    """prefill_fn's last logits and cache ({"dense", "moe"} stacks), step_fn
    over a chunk at an offset (with its MoE metrics), decode_fn at a
    shared position and at per-lane positions (the reference lane by
    lane)."""
    jb, jp, b, p = _bundles(name, dtype)
    assert set(p) == set(jp) == {"embed", "final_norm", "lm_head", "layers",
                                 "moe_layers"}
    assert param_count(b.param_defs) == sum(
        x.size for x in jax.tree.leaves(jp))
    rng = np.random.default_rng(5)
    cfg = b.cfg
    toks = _tokens(rng, cfg, (2, 9))
    jlg, jc = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        lg, c = b.prefill_fn(p, {"tokens": torch.from_numpy(toks)})
    close(lg, jlg, dtype)
    _cache_close(c, jc, dtype)

    jcache = jb.empty_cache(2, 16)
    _, jcache = jb.step_fn(jp, jcache, {"tokens": jnp.asarray(toks[:, :4]),
                                        "pos": jnp.int32(0)})
    jlog, jcache = jb.step_fn(jp, jcache, {
        "tokens": jnp.asarray(toks[:, 4:9]), "pos": jnp.int32(4)})
    cache = b.empty_cache(2, 16)
    with torch.no_grad():
        b.step_fn(p, cache, {"tokens": torch.from_numpy(toks[:, :4]),
                             "pos": 0})
        log, cache = b.step_fn(p, cache, {
            "tokens": torch.from_numpy(toks[:, 4:9]), "pos": 4})
    close(log, jlog, dtype)
    _cache_close(cache, jcache, dtype)

    nxt = _tokens(rng, cfg, (2, 1))
    jd, jcache = jb.decode_fn(jp, jcache, {"tokens": jnp.asarray(nxt),
                                           "pos": jnp.int32(9)})
    with torch.no_grad():
        d, cache = b.decode_fn(p, cache, {"tokens": torch.from_numpy(nxt),
                                          "pos": torch.tensor(9)})
    close(d, jd, dtype)
    _cache_close(cache, jcache, dtype)

    pos = np.array([10, 6], np.int32)
    with torch.no_grad():
        d, cache = b.decode_fn(p, cache, {"tokens": torch.from_numpy(nxt),
                                          "pos": torch.from_numpy(pos)})
    for i in range(2):
        lane = jax.tree.map(lambda a: a[:, i:i + 1], jcache)
        jd_i, lane = jb.decode_fn(jp, lane, {
            "tokens": jnp.asarray(nxt[i:i + 1]), "pos": jnp.int32(pos[i])})
        close(d[i:i + 1], jd_i, dtype)
        _cache_close({k: {kk: v[:, i:i + 1] for kk, v in leaves.items()}
                      for k, leaves in cache.items()}, lane, dtype)


@pytest.mark.parametrize("name", MOE)
def test_backbone_moe_metrics_match_the_reference(name):
    """The MoE stack's metrics at a capacity factor that drops tokens:
    ``moe_dropped`` (the share of pairs past capacity, averaged over the
    MoE layers) equal, ``moe_aux`` within fp32's tolerance."""
    jb, jp, b, p = _bundles(name, "float32")
    jcfg = jb.cfg.replace(capacity_factor=0.5)
    cfg = b.cfg.replace(capacity_factor=0.5)
    toks = _tokens(np.random.default_rng(6), cfg, (2, 24))
    x = jtr.embed_tokens(jp, jcfg, jnp.asarray(toks))
    _, _, jm = jtr.backbone(jp, jcfg, x, 0, None, remat=False)
    with torch.no_grad():
        _, m = ttr.backbone(p, cfg, ttr.embed_tokens(
            p, cfg, torch.from_numpy(toks)), 0, None)
    assert float(m["moe_dropped"]) > 0
    assert float(m["moe_dropped"]) == pytest.approx(
        float(jm["moe_dropped"]), rel=1e-6)
    close(m["moe_aux"], jm["moe_aux"])


@pytest.mark.parametrize("name", MOE)
def test_baked_tree_keeps_the_router_fp32(name):
    """bake_lm_params casts every leaf to bf16 but the router, and splits
    both stacks per layer; decode on the baked tree equals decode on the
    fp32 tree bit for bit."""
    _, _, b, p = _bundles(name, "bfloat16")
    baked = ttr.bake_lm_params(p, b.cfg)
    n_moe, n_dense = ttr.stack_sizes(b.cfg)
    assert len(baked["layers"]) == n_dense
    assert len(baked["moe_layers"]) == n_moe
    for i in range(n_moe):
        mlp = baked["moe_layers"][i]["mlp"]
        assert mlp["router"].dtype == torch.float32
        assert torch.equal(mlp["router"], p["moe_layers"]["mlp"]["router"][i])
        assert mlp["wg"].dtype == mlp["shared"]["wd"].dtype == torch.bfloat16
    assert ttr.bake_lm_params(baked, b.cfg)["embed"] is baked["embed"]
    toks = torch.tensor([[3], [5]], dtype=torch.int32)
    with torch.no_grad():
        a, _ = b.decode_fn(p, b.empty_cache(2, 8), {"tokens": toks, "pos": 0})
        c, _ = b.decode_fn(baked, b.empty_cache(2, 8),
                           {"tokens": toks, "pos": 0})
    assert torch.equal(a, c)


def test_mla_absorbed_decode_matches_baseline():
    """The twin of test_archs_smoke.py::test_mla_absorbed_decode_matches_
    baseline in the port: absorbed decode logits within atol 0.06 of the
    up-projection baseline, argmax equal."""
    cfg = get_config("deepseek-v2-lite-16b").smoke()
    b0 = build_bundle(cfg, "cpu")
    b1 = build_bundle(cfg.replace(mla_absorb=True), "cpu")
    params = b0.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(np.random.default_rng(1), cfg, (2, 17)))
    with torch.no_grad():
        c0 = b0.empty_cache(2, 17)
        b0.step_fn(params, c0, {"tokens": toks[:, :-1], "pos": 0})
        c1 = {k: {kk: v.clone() for kk, v in leaves.items()}
              for k, leaves in c0.items()}
        batch = {"tokens": toks[:, -1:], "pos": torch.tensor(16)}
        l0, _ = b0.decode_fn(params, c0, batch)
        l1, _ = b1.decode_fn(params, c1, batch)
    assert torch.equal(l0.argmax(-1), l1.argmax(-1))
    np.testing.assert_allclose(l0.numpy(), l1.numpy(), atol=0.06)


# ---------------------------------------------------------------------------
# an MLA LMSessionService
# ---------------------------------------------------------------------------

TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=64)


@functools.lru_cache(maxsize=None)
def _svc_pair(dtype: str):
    jcfg = j_get_config("deepseek-v2-lite-16b").smoke().replace(
        act_dtype=dtype, **TINY)
    jb = j_build_bundle(jcfg)
    jp = jb.init(jax.random.key(3))
    b = build_bundle(get_config("deepseek-v2-lite-16b").smoke().replace(
        act_dtype=dtype, **TINY), "cpu")
    return jb, jp, b, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _margins(jb, jp, prompt, tokens) -> list:
    dec = jax.jit(jb.decode_fn)
    cache = jb.empty_cache(1, 64)
    seq = np.concatenate([prompt, tokens]).astype(np.int32)
    out = []
    for i in range(len(prompt) + len(tokens) - 1):
        lg, cache = dec(jp, cache, {"tokens": jnp.asarray(seq[None, i:i + 1]),
                                    "pos": jnp.int32(i)})
        if i >= len(prompt) - 1:
            top = np.sort(np.asarray(lg[0]))[-2:]
            out.append(float(top[1] - top[0]))
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_mla_service_tokens_match_the_reference(paged):
    jb, jp, b, p = _svc_pair("float32")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (7, 20, 3)]
    kw = dict(n_slots=2, seq_cap=64, t_chunk=8, max_sessions=8)
    jsvc = JLMService(jb, jp, **kw)
    svc = LMSessionService(b, p, paged=paged, **kw)
    for prompt in prompts:
        js, s = jsvc.open_session(prompt), svc.open_session(prompt)
        want = jsvc.decode({js: 12})[js]
        got = svc.decode({s: 12})[s]
        margins = _margins(jb, jp, prompt, want)
        n = next((j for j, m in enumerate(margins) if m < 1e-3), len(want))
        assert got[:n] == want[:n], (n, margins)


def _bits(tree):
    return [np.asarray(x) for x in tree_leaves(numpy_bits(tree))]


def test_mla_paged_equals_dense_with_pooled_k_rope():
    """The 5-D k_rope leaf pools as (L, n_blocks + 1, block_len, 1, dr);
    paged (with a shared prompt prefix adopted copy-on-write) and dense
    services give the same tokens and the same latent rows, bit for bit,
    through evictions."""
    _, _, b, p = _svc_pair("bfloat16")
    kw = dict(n_slots=2, seq_cap=64, t_chunk=8, max_sessions=8,
              block_len=8)
    dense = LMSessionService(b, p, **kw)
    paged = LMSessionService(b, p, paged=True, **kw)
    pool = paged.cache["moe"]["k_rope"]
    assert pool.dim() == 5 and tuple(pool.shape[1:]) == (
        paged.pool.extent, 8, 1, b.cfg.qk_rope_dim)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 64, 17).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 64, n)]).astype(
        np.int32) for n in (3, 9, 1)]
    outs = []
    for svc in (dense, paged):
        sids = [svc.open_session(q) for q in prompts]  # one is parked
        got = [svc.decode({s: 10})[s] for s in sids]
        outs.append((got, [_bits(svc.live_column(s)) for s in sids[1:]]))
    assert outs[0][0] == outs[1][0]
    assert all(np.array_equal(x, y) for a, c in zip(outs[0][1], outs[1][1])
               for x, y in zip(a, c))
    assert paged.metrics()["prefix_block_hits_total"][0]["value"] >= 2


@pytest.mark.parametrize("paged", [False, True])
def test_mla_spill_files_cross_the_packages(tmp_path, paged):
    """bf16 MLA spills ({"dense", "moe"} x {"c_kv", "k_rope"}): the
    reference's file restores in the port with the same bits (and through
    a resume and a park again); the port's restores in the reference."""
    jb, jp, b, p = _svc_pair("bfloat16")
    kw = dict(n_slots=2, seq_cap=64, t_chunk=8, max_sessions=8, paged=paged)
    jsvc, svc = JLMService(jb, jp, **kw), LMSessionService(b, p, **kw)
    prompt = np.arange(3, 22, dtype=np.int32)
    js = jsvc.open_session(prompt)
    jsvc.decode({js: 5})
    jpath = str(tmp_path / "jax.npz")
    jsvc.spill_parking(jpath, include_bound=True)
    jbits = [np.asarray(x).view(np.uint16) if np.asarray(x).dtype.name ==
             "bfloat16" else np.asarray(x)
             for x in jax.tree.leaves(jsvc.parking[js])]
    assert set(jsvc.parking[js]["kv"]["moe"]) == {"c_kv", "k_rope"}
    assert svc.restore_parking(jpath) == [js]
    assert all(np.array_equal(x, y)
               for x, y in zip(_bits(svc.parking[js]), jbits))
    assert svc.outputs[js] == jsvc.outputs[js]
    svc.resume(js)
    svc.park(js)
    assert all(np.array_equal(x, y)
               for x, y in zip(_bits(svc.parking[js]), jbits))
    assert len(svc.decode({js: 3})[js]) == 3
    ppath = str(tmp_path / "port.npz")
    svc.spill_parking(ppath, include_bound=True)
    fresh = JLMService(jb, jp, **kw)
    assert fresh.restore_parking(ppath) == [js]
    back = [np.asarray(x).view(np.uint16) if np.asarray(x).dtype.name ==
            "bfloat16" else np.asarray(x)
            for x in jax.tree.leaves(fresh.parking[js])]
    assert all(np.array_equal(x, y)
               for x, y in zip(back, _bits(svc.parking[js])))
    assert len(fresh.decode({js: 2})[js]) == 2
