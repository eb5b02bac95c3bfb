"""The recurrent LM families of the port against the JAX reference, on the
CPU: RWKV6's ``wkv_step``/``wkv_chunked`` and Mamba2's ``ssd_step``/
``ssd_chunked``/``_causal_conv`` against the reference's on the same
seeded inputs, the chunked forms against the token recurrence inside the
port (after tests/test_layers.py's ``TestSequenceMixers``), then the
rwkv6-1.6b and zamba2-1.2b bundles (``prefill_fn``, ``decode_fn``,
``step_fn``, ``embed_fn``) against the reference's at the reference
tests' widths (2 layers, d_model 32, d_ff 64, vocab 64, RWKV head 16),
with the cache trees compared field for field, the full configs' param
and cache trees equal to the reference's, and the baked tree.

Params come from the reference's ``init`` with every leaf its init leaves
at zero or one (the token-shift mixes, the decay base, the bonus, the
group norm, ``a_log``, ``dt_bias``, ``d_skip``, the norms) redrawn from a
seeded numpy stream, so parity covers them.  Tolerances (PERF.md §2): at
fp32, rtol 1e-4 and atol 1e-5 x max(1, max|want|); at bf16, max|got -
want| <= 5e-2 x max(1, max|want|).  Chunked against steps inside the port:
atol 5e-4, the reference test's."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models import rwkv as jr  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.models import rwkv as tr  # noqa: E402
from repro_torch.models import ssm as ts  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    FP32_LEAVES,
    bake_lm_params,
)
from repro_torch.utils.trees import tree_leaves  # noqa: E402

BF16_REL = 5e-2
V = 64
ARCHS = {
    "rwkv": ("rwkv6-1.6b", dict(n_layers=2, d_model=32, d_ff=64,
                                vocab_size=V, rwkv_head_dim=16)),
    "ssm": ("zamba2-1.2b", dict(n_layers=2, d_model=32, d_ff=64,
                                vocab_size=V)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module, restored after it (tiny ops
    gain nothing from threads when test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def close(got, want, dtype="float32"):
    got, want = _t(got).astype(np.float32), _np(want).astype(np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        assert float(np.abs(got - want).max(initial=0.0)) \
            <= BF16_REL * scale


def close_tree(got, want, dtype):
    """Two cache trees field for field: the same keys, shapes and dtypes
    (bf16 where the reference's is bf16, fp32 states), values close."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            close_tree(got[k], want[k], dtype)
        return
    assert str(got.dtype).split(".")[-1] == np.asarray(want).dtype.name
    # a state is fp32 whatever the activations: its tolerance is theirs
    close(got, want, dtype)


def _rng_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# the sequence mixers
# ---------------------------------------------------------------------------

def _wkv_inputs(B, T, H, Dh, seed=0):
    r, k, v, lw, u, s0 = _rng_inputs(seed, (B, T, H, Dh), (B, T, H, Dh),
                                     (B, T, H, Dh), (B, T, H, Dh), (H, Dh),
                                     (B, H, Dh, Dh))
    return r, k, v, -np.exp(lw * 0.5), u * 0.1, s0 * 0.1


@pytest.mark.parametrize("T", [1, 5, 32, 75])
def test_wkv_matches_the_reference(T):
    """``wkv_chunked`` (a ragged last chunk at 5 and 75) and ``wkv_step``
    (every token of the same stream) against the reference's."""
    args = _wkv_inputs(2, T, 2, 8)
    want_y, want_s = jr.wkv_chunked(*map(jnp.asarray, args))
    got_y, got_s = tr.wkv_chunked(*map(torch.from_numpy, args))
    close(got_y, want_y)
    close(got_s, want_s)
    r, k, v, lw, u, s = args
    js_, ts_ = jnp.asarray(s), torch.from_numpy(s)
    for t in range(T):
        jy, js_ = jr.wkv_step(*(jnp.asarray(a[:, t]) for a in (r, k, v, lw)),
                              jnp.asarray(u), js_)
        ty, ts_ = tr.wkv_step(*(torch.from_numpy(a[:, t])
                                for a in (r, k, v, lw)),
                              torch.from_numpy(u), ts_)
        close(ty, jy)
    close(ts_, js_)


def test_wkv_chunked_equals_recurrence():
    """Inside the port: the chunked form against the token recurrence."""
    r, k, v, lw, u, s0 = map(torch.from_numpy, _wkv_inputs(2, 75, 2, 8, 3))
    ys, s = [], s0
    for t in range(75):
        y, s = tr.wkv_step(r[:, t], k[:, t], v[:, t], lw[:, t], u, s)
        ys.append(y)
    y_c, s_c = tr.wkv_chunked(r, k, v, lw, u, s0)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_c.numpy(),
                               atol=5e-4)
    np.testing.assert_allclose(s.numpy(), s_c.numpy(), atol=5e-4)


def _ssd_inputs(B, T, H, P, N, seed=1):
    x, dt, a, bm, cm, s0 = _rng_inputs(seed, (B, T, H, P), (B, T, H), (H,),
                                       (B, T, N), (B, T, N), (B, H, N, P))
    return (x, np.log1p(np.exp(dt)).astype(np.float32),
            -np.exp(a * 0.3).astype(np.float32), bm, cm, s0 * 0.1)


@pytest.mark.parametrize("T", [1, 9, 64, 70])
def test_ssd_matches_the_reference(T):
    args = _ssd_inputs(2, T, 2, 8, 8)
    want_y, want_s = js.ssd_chunked(*map(jnp.asarray, args))
    got_y, got_s = ts.ssd_chunked(*map(torch.from_numpy, args))
    close(got_y, want_y)
    close(got_s, want_s)
    x, dt, A, bm, cm, s = args
    js_, ts_ = jnp.asarray(s), torch.from_numpy(s)
    for t in range(T):
        jy, js_ = js.ssd_step(jnp.asarray(x[:, t]), jnp.asarray(dt[:, t]),
                              jnp.asarray(A), jnp.asarray(bm[:, t]),
                              jnp.asarray(cm[:, t]), js_)
        ty, ts_ = ts.ssd_step(torch.from_numpy(x[:, t]),
                              torch.from_numpy(dt[:, t]), torch.from_numpy(A),
                              torch.from_numpy(bm[:, t]),
                              torch.from_numpy(cm[:, t]), ts_)
        close(ty, jy)
    close(ts_, js_)


def test_ssd_chunked_equals_recurrence():
    x, dt, A, bm, cm, s0 = map(torch.from_numpy, _ssd_inputs(2, 70, 2, 8, 8,
                                                              5))
    ys, s = [], s0
    for t in range(70):
        y, s = ts.ssd_step(x[:, t], dt[:, t], A, bm[:, t], cm[:, t], s)
        ys.append(y)
    y_c, s_c = ts.ssd_chunked(x, dt, A, bm, cm, s0)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_c.numpy(),
                               atol=5e-4)
    np.testing.assert_allclose(s.numpy(), s_c.numpy(), atol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_ring(dtype):
    """The depthwise causal conv and its (K-1)-deep ring against the
    reference's, with a ring and without; a sequence fed in two pieces
    through the ring equals it fed whole."""
    x, w, b, ring = _rng_inputs(2, (2, 7, 6), (4, 6), (6,), (2, 3, 6))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for rg in (None, ring):
        jy, jring = js._causal_conv(
            jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b),
            None if rg is None else jnp.asarray(rg, jd))
        ty, tring = ts._causal_conv(
            torch.from_numpy(x).to(td), torch.from_numpy(w),
            torch.from_numpy(b),
            None if rg is None else torch.from_numpy(rg).to(td))
        close(ty, jy, dtype)
        close(tring, jring, dtype)
    xt = torch.from_numpy(x)
    whole, r_whole = ts._causal_conv(xt, torch.from_numpy(w),
                                     torch.from_numpy(b))
    a, r1 = ts._causal_conv(xt[:, :3], torch.from_numpy(w),
                            torch.from_numpy(b))
    c, r2 = ts._causal_conv(xt[:, 3:], torch.from_numpy(w),
                            torch.from_numpy(b), r1)
    assert torch.equal(torch.cat([a, c], 1), whole)
    assert torch.equal(r2, r_whole)


# ---------------------------------------------------------------------------
# the bundles against the reference
# ---------------------------------------------------------------------------

# leaves the reference inits to zeros or ones: redrawn so parity covers them
_REDRAW = {"mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "w0", "u", "gn_w",
           "gn_b", "a_log", "dt_bias", "d_skip", "conv_b", "w", "b"}


def _redraw(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree)
    if key in _REDRAW:
        a = (a + 0.3 * rng.normal(size=a.shape)).astype(a.dtype)
    return a


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    """(reference bundle, its params, port bundle, the same params)."""
    name, extra = ARCHS[arch]
    jb = j_build_bundle(j_get_config(name).smoke().replace(
        act_dtype=dtype, **extra))
    jp = _redraw(jax.tree.map(np.asarray, jb.init(jax.random.key(3))),
                 np.random.default_rng(4))
    b = build_bundle(get_config(name).smoke().replace(act_dtype=dtype,
                                                      **extra), "cpu")
    return jb, jax.tree.map(jnp.asarray, jp), b, params_from_jax(jp, "cpu")


def _bits_cache(tree):
    """A reference cache tree as numpy, bf16 leaves as their uint16 bits
    (what ``params_from_jax`` takes)."""
    def leaf(a):
        a = np.array(a)  # a writable copy
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_bundle_matches_the_reference(arch, dtype):
    """``prefill_fn`` over a 37-token prompt (the chunked forms, a ragged
    last chunk), then ``decode_fn`` from the reference's own cache at
    per-lane positions, ``step_fn`` over 5 tokens and ``embed_fn``:
    logits and every cache leaf against the reference's."""
    jb, jp, b, p = _pair(arch, dtype)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, V, (2, 37)).astype(np.int32)
    jl, jc = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = b.prefill_fn(p, {"tokens": torch.from_numpy(toks)})
    close(tl, jl, dtype)
    close_tree(tc, jc, dtype)
    # the reference's decode takes one position for the batch; the port's
    # a position per lane (both at 37 here)
    if arch == "ssm":  # the KV rows past the prompt: a longer cache
        jcache = jb.empty_cache(2, 48)
        jcache = jax.tree.map(
            lambda e, c: e.at[tuple(slice(0, n) for n in c.shape)].set(c),
            jcache, jc)
    else:
        jcache = jc
    nxt = rng.integers(0, V, (2, 1)).astype(np.int32)
    jl2, jc2 = jb.decode_fn(jp, jcache, {"tokens": jnp.asarray(nxt),
                                         "pos": jnp.int32(37)})
    tcache = params_from_jax(_bits_cache(jcache), "cpu")
    with torch.no_grad():
        tl2, tc2 = b.decode_fn(p, tcache, {
            "tokens": torch.from_numpy(nxt),
            "pos": torch.tensor([37, 37], dtype=torch.int32)})
    close(tl2, jl2, dtype)
    close_tree(tc2, jc2, dtype)
    # step_fn: 5 tokens from the decode's cache
    more = rng.integers(0, V, (2, 5)).astype(np.int32)
    jl3, jc3 = jb.step_fn(jp, jc2, {"tokens": jnp.asarray(more),
                                    "pos": jnp.int32(38)})
    with torch.no_grad():
        tl3, tc3 = b.step_fn(p, params_from_jax(_bits_cache(jc2), "cpu"), {
            "tokens": torch.from_numpy(more), "pos": 38})
    close(tl3, jl3, dtype)
    close_tree(tc3, jc3, dtype)
    je = jb.embed_fn(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        te = b.embed_fn(p, {"tokens": torch.from_numpy(toks)})
    close(te, je, dtype)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cached_call_leaves_recurrent_leaves_intact(arch):
    """A cached call returns new recurrent tensors and writes none of the
    cache it was given (the value mask needs the old ones); zamba's KV
    leaves are written in place, at the lane's position only."""
    _, _, b, p = _pair(arch, "float32")
    cache = b.empty_cache(2, 16)
    for leaf in tree_leaves(cache):
        leaf.normal_(generator=torch.Generator().manual_seed(0))
    rec = cache if arch == "rwkv" else cache["mamba"]
    before = {k: v.clone() for k, v in rec.items()}
    k_old = None if arch == "rwkv" else cache["attn"]["k"].clone()
    with torch.no_grad():
        _, new = b.decode_fn(p, cache, {
            "tokens": torch.tensor([[1], [2]], dtype=torch.int32),
            "pos": torch.tensor([3, 9], dtype=torch.int32)})
    new_rec = new if arch == "rwkv" else new["mamba"]
    for k in rec:
        assert new_rec[k] is not rec[k]
        assert torch.equal(rec[k], before[k])
        assert not torch.equal(new_rec[k], before[k])
    if arch == "ssm":
        k_new = cache["attn"]["k"]
        assert new["attn"]["k"] is k_new
        changed = (k_new != k_old).any(-1).any(-1)  # (n_apps, B, S)
        want = torch.zeros_like(changed)
        want[:, 0, 3] = want[:, 1, 9] = True
        assert torch.equal(changed, want)


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_full_configs_match_the_reference(name):
    """At full size (on the meta device): the param tree's shapes, axes,
    inits and scales, and the cache tree's shapes and dtypes, equal the
    reference's; the parameter count is the reference's."""
    from repro.launch.analytic import param_count as j_param_count
    from repro_torch.models.params import param_count

    b = build_bundle(get_config(name), "cpu")
    jb = j_build_bundle(j_get_config(name))

    def flat(tree, is_leaf=None):
        return jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]

    got = {jax.tree_util.keystr(k): (tuple(d.shape), tuple(d.axes), d.init,
                                     d.scale)
           for k, d in flat(b.param_defs,
                            lambda x: not isinstance(x, dict))}
    want = {jax.tree_util.keystr(k): (tuple(d.shape), tuple(d.axes), d.init,
                                      d.scale)
            for k, d in flat(jb.param_defs,
                             lambda x: not isinstance(x, dict))}
    assert got == want
    assert param_count(b.param_defs) == j_param_count(jb.param_defs)
    specs = b.cache_specs(8, 1024)
    jspecs = jb.cache_specs(8, 1024)
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
           for k, v in flat(specs, lambda x: not isinstance(x, dict))}
    want = {jax.tree_util.keystr(k): (tuple(v.shape),
                                      "torch." + str(v.dtype))
            for k, v in flat(jspecs)}
    assert got == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_baked_tree_keeps_fp32_leaves_and_decodes_alike(arch):
    """The baked bf16 tree keeps the leaves the reference casts to fp32
    at their use in fp32, and its decode equals the raw fp32 tree's
    (cast at each use) bit for bit."""
    _, _, b, p = _pair(arch, "bfloat16")
    baked = bake_lm_params(p, b.cfg)
    kinds = set()

    def walk(node, key=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, key)
        else:
            kinds.add((key, node.dtype))

    walk(baked)
    for key, dt in kinds:
        assert dt == (torch.float32 if key in FP32_LEAVES
                      else torch.bfloat16), key
    assert {k for k, _ in kinds} & FP32_LEAVES
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    pos = torch.tensor([0, 4], dtype=torch.int32)
    with torch.no_grad():
        a, ca = b.decode_fn(p, b.empty_cache(2, 8), {"tokens": tok,
                                                     "pos": pos})
        c, cc = b.decode_fn(baked, b.empty_cache(2, 8), {"tokens": tok,
                                                         "pos": pos})
    assert torch.equal(a, c)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(ca), tree_leaves(cc)))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_head_dim_64_matches_the_reference(arch):
    """At the served head widths (RWKV's 64-wide wkv heads, Mamba's
    64-wide heads and a 64-wide state) in fp32: the chunked prefill over
    16 tokens and 16 decode steps from an empty cache, logits against the
    reference's."""
    name, _ = ARCHS[arch]
    extra = dict(n_layers=2, d_model=128, d_ff=256, vocab_size=V,
                 act_dtype="float32")
    if arch == "ssm":
        extra.update(n_heads=2, n_kv_heads=2, head_dim=64, ssm_state=64,
                     ssm_head_dim=64, attn_every=2)
    jb = j_build_bundle(j_get_config(name).replace(**extra))
    jp = _redraw(jax.tree.map(np.asarray, jb.init(jax.random.key(5))),
                 np.random.default_rng(6))
    b = build_bundle(get_config(name).replace(**extra), "cpu")
    p = params_from_jax(jp, "cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    toks = np.random.default_rng(8).integers(0, V, (2, 16)).astype(np.int32)
    jl, _ = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _ = b.prefill_fn(p, {"tokens": torch.from_numpy(toks)})
    close(tl, jl)
    jc, tc = jb.empty_cache(2, 16), b.empty_cache(2, 16)
    for i in range(16):
        jl, jc = jb.decode_fn(jp, jc, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                                       "pos": jnp.int32(i)})
        with torch.no_grad():
            tl, tc = b.decode_fn(p, tc, {
                "tokens": torch.from_numpy(toks[:, i:i + 1]),
                "pos": torch.tensor([i, i], dtype=torch.int32)})
        close(tl, jl)
    close_tree(tc, jc, "float32")
