"""The vlm and encoder-decoder audio families of the port against the JAX
reference, on the CPU: internvl2-76b (patch embeddings in front of the
text) and seamless-m4t-large-v2 (a non-causal encoder over frame
embeddings, cross attention in every decoder layer) at their ``smoke()``
cuts, on params converted with ``params_from_jax``.

Against the reference: the full configs' param and cache trees (names,
shapes, axes, dtypes); ``gqa_attn``'s two cross modes (K/V from the
encoder output, with and without a cache to fill; the cached cross K/V);
``layer_fwd`` with ``enc_h`` and with a cached cross; ``run_encoder`` at
the default ``attn_chunk_threshold`` (the dense path) and at 8 (the
chunked non-causal path the full model takes at 4,096 frames); the
bundles' ``prefill_fn``/``decode_fn``/``step_fn``/``embed_fn``, and the
reference's decode-after-prefill contract; ``LMSessionService`` greedy
tokens over token prompts, dense and paged; the park-bytes coefficients;
spill files of the seamless service crossing the packages; ``adapt`` over
both bundles' ``embed_fn`` (the ``proto_extract`` plain version on the
CPU).  Inside the port, bit for bit: a step passes the untouched cross
leaves through the value mask, and that equals ``lane_select``-ing them;
the seamless service's t_chunk, layout and park/resume invariance.

Tolerances: fp32 rtol 1e-4, atol 1e-5 x max(1, max|want|); bf16
max|got - want| <= 5e-2 x max(1, max|want|); greedy tokens equal up to
the reference's first top-2 logit margin below 1e-3; the
decode-after-prefill contract at the reference's rtol 3e-2, atol 3e-2."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import protonet as j_protonet  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models import layers as jl_mod  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.sessions import LMSessionService as JLMService  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import numpy_bits, params_from_jax  # noqa: E402
from repro_torch.core import protonet  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.models import layers as tl_mod  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.sessions import LMSessionService  # noqa: E402
from repro_torch.sessions import lm as lm_mod  # noqa: E402
from repro_torch.utils.trees import tree_leaves, tree_map  # noqa: E402

BF16_REL = 5e-2
AUDIO, VLM = "seamless-m4t-large-v2", "internvl2-76b"
# (config, extra fields of the smoke cut): internvl's GQA 64/8 with
# attn_kv_repeat keeps KV heads below query heads
ARCHS = {
    "audio": (AUDIO, {}),
    "vlm": (VLM, {}),
    "vlm-gqa": (VLM, dict(n_heads=4, n_kv_heads=2)),
}
N_FRAMES = 17


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
    """Two cache trees leaf for leaf: the same keys, shapes and dtypes,
    values close."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            close_tree(got[k], want[k], dtype)
        return
    assert str(got.dtype).split(".")[-1] == np.asarray(want).dtype.name
    close(got, want, dtype)


def _host(tree):
    """A reference tree as writable numpy, bf16 leaves as uint16 bits
    (what ``params_from_jax`` takes)."""
    def leaf(a):
        a = np.array(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    return jax.tree.map(leaf, tree)


def _redraw(tree, rng, key=None):
    """Move the norms' unit scales and zero biases off their init, so the
    affine parts are exercised."""
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree)
    if key in ("w", "b"):
        a = (a + 0.3 * rng.normal(size=a.shape)).astype(a.dtype)
    return a


def _cfgs(arch, dtype, threshold=None):
    name, extra = ARCHS[arch]
    if threshold is not None:
        extra = {**extra, "attn_chunk_threshold": threshold}
    return (j_get_config(name).smoke().replace(act_dtype=dtype, **extra),
            get_config(name).smoke().replace(act_dtype=dtype, **extra))


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype, threshold=None):
    """(reference bundle, its params, port bundle, the same params)."""
    jc, tc = _cfgs(arch, dtype, threshold)
    jb = j_build_bundle(jc)
    jp = _redraw(jax.tree.map(np.asarray, jb.init(jax.random.key(3))),
                 np.random.default_rng(4))
    b = build_bundle(tc, "cpu")
    return jb, jax.tree.map(jnp.asarray, jp), b, params_from_jax(jp, "cpu")


def _front(cfg, rng, B):
    """The front end's batch keys: seeded patch or frame embeddings."""
    if cfg.family == "vlm":
        return {"patches": (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
                            * 0.5).astype(np.float32)}
    return {"frames": (rng.normal(size=(B, N_FRAMES, cfg.d_model))
                       * 0.5).astype(np.float32)}


def _batches(batch, dtype):
    """One numpy batch as (jnp, torch) dicts; embeddings in ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j = {k: jnp.asarray(v, jd if v.dtype == np.float32 else None)
         for k, v in batch.items()}
    t = {k: torch.from_numpy(v).to(td) if v.dtype == np.float32
         else torch.from_numpy(v) for k, v in batch.items()}
    return j, t


def _flat(tree, is_leaf=None):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_full_configs_match_the_reference(name):
    """At full size: the param defs' names, shapes, axes, inits and
    scales, the parameter count, and ``cache_specs(8, 1024)`` leaf for
    leaf (shapes and dtypes) equal the reference's."""
    from repro.launch.analytic import param_count as j_param_count
    from repro_torch.models.params import param_count

    b = build_bundle(get_config(name), "cpu")
    jb = j_build_bundle(j_get_config(name))
    is_def = lambda x: not isinstance(x, dict)
    spec = lambda d: (tuple(d.shape), tuple(d.axes), d.init, d.scale)
    assert {k: spec(d) for k, d in _flat(b.param_defs, is_def).items()} == \
        {k: spec(d) for k, d in _flat(jb.param_defs, is_def).items()}
    assert param_count(b.param_defs) == j_param_count(jb.param_defs)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in _flat(b.cache_specs(8, 1024), is_def).items()}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat(jb.cache_specs(8, 1024)).items()}
    assert got == want
    if name == AUDIO:
        assert got["['self']['cross']['k']"][0] == (24, 8, 4096, 16, 64)
        assert {"enc_layers", "enc_norm"} <= set(b.param_defs)
        assert {"cross", "cross_norm"} <= set(b.param_defs["layers"])


@pytest.mark.parametrize("arch", ["audio", "vlm"])
def test_baked_tree_unstacks_every_stack(arch):
    """``bake_lm_params`` splits ``enc_layers`` into per-layer trees as it
    does the decoder's, so no stacked tree leaks into the served params;
    the baked tree's prefill equals the fp32 tree's (cast at each use)
    bit for bit."""
    _, _, b, p = _pair(arch, "bfloat16")
    baked = tt.bake_lm_params(p, b.cfg)
    stacks = [k for k in ("layers", "enc_layers") if k in p]
    assert stacks == (["layers", "enc_layers"] if arch == "audio"
                      else ["layers"])
    for k in stacks:
        assert isinstance(baked[k], list) and len(baked[k]) == 2
        assert all(t.dim() <= 2 for t in tree_leaves(baked[k]))
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(baked))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, b.cfg.vocab_size, (2, 6)).astype(
        np.int32), **_front(b.cfg, rng, 2)}
    _, tb = _batches(batch, "bfloat16")
    with torch.no_grad():
        a, ca = b.prefill_fn(p, tb)
        c, cc = b.prefill_fn(baked, tb)
    assert torch.equal(a, c)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(ca), tree_leaves(cc)))


# ---------------------------------------------------------------------------
# cross attention, the layer body and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [None, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_cross_modes(dtype, threshold):
    """``kv_x`` (K/V from the encoder output: no rope, not causal; with a
    cache, copied into it; without, the uncached form the embedder runs)
    and ``cross_cached`` (the cached K/V, read, never written), at one
    query and at 6; at threshold 8 the multi-query calls take the
    chunked non-causal path."""
    jb, jp, b, p = _pair("audio", dtype, threshold)
    jc, tc = jb.cfg, b.cfg
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["cross"])
    tl = {k: v[0] for k, v in p["layers"]["cross"].items()}
    rng = np.random.default_rng(11)
    for S in (1, 6):
        x, enc = (rng.normal(size=s).astype(np.float32)
                  for s in ((2, S, tc.d_model), (2, N_FRAMES, tc.d_model)))
        (jx, jenc), (tx, tenc) = zip(*(
            (v["a"], w["a"]) for v, w in
            (_batches({"a": a}, dtype) for a in (x, enc))))
        # uncached: the embedder's and the encoder-decoder's train form
        want, _ = jt.gqa_attn(jl, jc, jx, None, None, None, causal=False,
                              kv_x=jenc)
        with torch.no_grad():
            got = tt.gqa_attn(tl, tc, tx, None, None, None, causal=False,
                              kv_x=tenc)
        close(got, want, dtype)
        # the cross prefill: the cache is filled with the encoder K/V
        shape = (2, N_FRAMES, tc.n_kv_heads, tc.dh)
        jcache = {"k": jnp.zeros(shape, jx.dtype),
                  "v": jnp.zeros(shape, jx.dtype)}
        want, jnew = jt.gqa_attn(jl, jc, jx, None, jcache, None,
                                 causal=False, kv_x=jenc)
        tcache = {"k": torch.zeros(shape, dtype=tx.dtype),
                  "v": torch.zeros(shape, dtype=tx.dtype)}
        with torch.no_grad():
            got = tt.gqa_attn(tl, tc, tx, None, tcache, None, causal=False,
                              kv_x=tenc)
        close(got, want, dtype)
        close_tree(tcache, jnew, dtype)
        # the cached cross: read, never written
        before = {k: v.clone() for k, v in tcache.items()}
        want, jsame = jt.gqa_attn(jl, jc, jx, None, jnew, None,
                                  causal=False, cross_cached=True)
        with torch.no_grad():
            got = tt.gqa_attn(tl, tc, tx, None, tcache, None, causal=False,
                              cross_cached=True)
        close(got, want, dtype)
        assert jsame is jnew
        assert all(torch.equal(tcache[k], before[k]) for k in tcache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_fwd_with_enc_h_and_cached_cross(dtype):
    """A decoder layer (self attention, MLP, then cross attention with its
    own norm): a prefill with ``enc_h`` filling the self and cross
    caches, then a one-token step against them, each against the
    reference's layer."""
    jb, jp, b, p = _pair("audio", dtype)
    jc, tc = jb.cfg, b.cfg
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    tl = tt.unstack_layers(p["layers"])[1]
    rng = np.random.default_rng(12)
    S, smax = 5, 8
    x, enc, x1 = (rng.normal(size=s).astype(np.float32) for s in (
        (2, S, tc.d_model), (2, N_FRAMES, tc.d_model), (2, 1, tc.d_model)))
    j, t = _batches({"x": x, "enc": enc, "x1": x1}, dtype)
    kv = (2, smax, tc.n_kv_heads, tc.dh)
    ckv = (2, N_FRAMES, tc.n_kv_heads, tc.dh)
    jcache = {"k": jnp.zeros(kv, j["x"].dtype),
              "v": jnp.zeros(kv, j["x"].dtype),
              "cross": {"k": jnp.zeros(ckv, j["x"].dtype),
                        "v": jnp.zeros(ckv, j["x"].dtype)}}
    tcache = {"k": torch.zeros(kv, dtype=t["x"].dtype),
              "v": torch.zeros(kv, dtype=t["x"].dtype),
              "cross": {"k": torch.zeros(ckv, dtype=t["x"].dtype),
                        "v": torch.zeros(ckv, dtype=t["x"].dtype)}}
    jrope = lambda pos, n: jl_mod.rope_angles(pos + jnp.arange(n), tc.dh,
                                              tc.rope_theta)
    trope = lambda pos, n: tl_mod.rope_angles(pos + torch.arange(n), tc.dh,
                                              tc.rope_theta)
    want, jnew, _ = jt.layer_fwd(jl, jc, j["x"], jrope(0, S), jcache, 0,
                                 moe=False, enc_h=j["enc"])
    with torch.no_grad():
        got, _ = tt.layer_fwd(tl, tc, t["x"], trope(0, S), tcache, 0,
                              enc_h=t["enc"])
    close(got, want, dtype)
    close_tree(tcache, jnew, dtype)
    want, jnew2, _ = jt.layer_fwd(jl, jc, j["x1"], jrope(S, 1), jnew,
                                  jnp.int32(S), moe=False)
    with torch.no_grad():
        got, _ = tt.layer_fwd(tl, tc, t["x1"], trope(S, 1), tcache,
                              torch.tensor(S, dtype=torch.int32))
    close(got, want, dtype)
    close_tree(tcache, jnew2, dtype)


@pytest.mark.parametrize("threshold", [None, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_encoder(dtype, threshold):
    """The non-causal encoder over 17 frames (rope over 0..16,
    ``enc_norm``): the dense path at the default threshold, the chunked
    non-causal path at threshold 8."""
    jb, jp, b, p = _pair("audio", dtype, threshold)
    frames = (np.random.default_rng(13).normal(
        size=(2, N_FRAMES, b.cfg.d_model)) * 0.5).astype(np.float32)
    j, t = _batches({"f": frames}, dtype)
    want = jt.run_encoder(jp, jb.cfg, j["f"], remat=False)
    with torch.no_grad():
        got = tt.run_encoder(p, b.cfg, t["f"])
    close(got, want, dtype)
    if threshold is None:  # the two paths agree with each other too
        _, _, b8, p8 = _pair("audio", dtype, 8)
        with torch.no_grad():
            close(tt.run_encoder(p8, b8.cfg, t["f"]), want, dtype)


# ---------------------------------------------------------------------------
# the bundles
# ---------------------------------------------------------------------------

BUNDLE_CASES = [("audio", None), ("audio", 8), ("vlm", None), ("vlm", 8),
                ("vlm-gqa", None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,threshold", BUNDLE_CASES)
def test_bundle_matches_the_reference(arch, threshold, dtype):
    """``prefill_fn`` over the front end and 7 tokens (the cache tree: the
    seamless cross leaves at the frames' length), ``decode_fn`` from the
    reference's cache grown by a row at per-lane positions (vlm: after
    the patches), ``step_fn`` over 4 tokens and ``embed_fn``: logits,
    every cache leaf and the embeddings against the reference's."""
    jb, jp, b, p = _pair(arch, dtype, threshold)
    cfg = b.cfg
    rng = np.random.default_rng(7)
    S = 7
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, S)).astype(
        np.int32), **_front(cfg, rng, 2)}
    jbatch, tbatch = _batches(batch, dtype)
    jl, jc = jb.prefill_fn(jp, jbatch)
    with torch.no_grad():
        tl, tc = b.prefill_fn(p, tbatch)
    close(tl, jl, dtype)
    close_tree(tc, jc, dtype)
    if arch == "audio":
        assert tuple(tc["self"]["cross"]["k"].shape)[2] == N_FRAMES
    pos = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    grow = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 5)]
                             + [(0, 0)] * (a.ndim - 3)) \
        if a.shape[2] == pos else a
    jcache = jax.tree.map(grow, jc)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl2, jc2 = jb.decode_fn(jp, jcache, {"tokens": jnp.asarray(nxt),
                                         "pos": jnp.int32(pos)})
    with torch.no_grad():
        tl2, tc2 = b.decode_fn(p, params_from_jax(_host(jcache), "cpu"), {
            "tokens": torch.from_numpy(nxt),
            "pos": torch.tensor([pos, pos], dtype=torch.int32)})
    close(tl2, jl2, dtype)
    close_tree(tc2, jc2, dtype)
    more = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    jl3, jc3 = jb.step_fn(jp, jc2, {"tokens": jnp.asarray(more),
                                    "pos": jnp.int32(pos + 1)})
    with torch.no_grad():
        tl3, tc3 = b.step_fn(p, params_from_jax(_host(jc2), "cpu"), {
            "tokens": torch.from_numpy(more), "pos": pos + 1})
    close(tl3, jl3, dtype)
    close_tree(tc3, jc3, dtype)
    je = jb.embed_fn(jp, jbatch)
    with torch.no_grad():
        te = b.embed_fn(p, tbatch)
    close(te, je, dtype)


def test_step_against_the_empty_cross_cache():
    """A session's cache: the cross leaves at ENCDEC_ENC_LEN zero rows.
    ``step_fn`` over 6 tokens (at threshold 4096 the chunked non-causal
    path over the 4,096 cross rows) and ``decode_fn``, against the
    reference's on its empty cache."""
    jb, jp, b, p = _pair("audio", "float32")
    rng = np.random.default_rng(8)
    toks = rng.integers(0, b.cfg.vocab_size, (2, 6)).astype(np.int32)
    jl, jc = jb.step_fn(jp, jb.empty_cache(2, 16), {
        "tokens": jnp.asarray(toks), "pos": jnp.int32(0)})
    with torch.no_grad():
        tl, tc = b.step_fn(p, b.empty_cache(2, 16), {
            "tokens": torch.from_numpy(toks), "pos": 0})
    close(tl, jl)
    close_tree(tc, jc, "float32")
    nxt = toks[:, :1]
    jl2, _ = jb.decode_fn(jp, jc, {"tokens": jnp.asarray(nxt),
                                   "pos": jnp.int32(6)})
    with torch.no_grad():
        tl2, tc2 = b.decode_fn(p, tc, {"tokens": torch.from_numpy(nxt),
                                       "pos": torch.tensor([6, 6])})
    close(tl2, jl2)
    assert tc2["self"]["cross"]["k"] is tc["self"]["cross"]["k"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_consistent_with_prefill(arch):
    """tests/test_archs_smoke.py:46 in the port: prefill(tokens[:S]) last
    logits against prefill(tokens[:S-1]) and one ``decode_fn`` step (vlm:
    at a position counting the patches), bf16, rtol 3e-2, atol 3e-2."""
    _, _, b, p = _pair(arch, "bfloat16")
    cfg = b.cfg
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 17)).astype(
        np.int32), **_front(cfg, rng, 2)}
    _, t = _batches(batch, "bfloat16")
    toks = t["tokens"]
    prefix = toks.shape[1] - 1 + (cfg.n_patches if cfg.family == "vlm"
                                  else 0)
    with torch.no_grad():
        full, _ = b.prefill_fn(p, t)
        _, cache = b.prefill_fn(p, {**t, "tokens": toks[:, :-1]})
        grow = lambda a: torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, 1)) if a.shape[2] == prefix else a
        cache = tree_map(grow, cache)
        step, _ = b.decode_fn(p, cache, {"tokens": toks[:, -1:],
                                         "pos": prefix})
    np.testing.assert_allclose(full.numpy(), step.numpy(), rtol=3e-2,
                               atol=3e-2)


def test_contract_gap_at_depth_comes_from_the_chunked_cross_prefill():
    """At full depth (24 encoder and 24 decoder layers, narrow), bf16, with
    256 frames at ``attn_chunk_threshold`` 256: the full prefill's
    multi-query cross attention takes the chunked path and the decode's
    the dense one, so the decode-after-prefill gap is that of two
    attention formulations, and the port's matches the reference's (each
    within the bf16 tolerance of the other's); with every call dense the
    contract holds in both, and in fp32 the gap is rounding (<= 1e-4 of
    the logits' scale)."""
    over = dict(n_layers=24, n_enc_layers=24, d_model=128, n_heads=2,
                n_kv_heads=2, head_dim=64, d_ff=256, vocab_size=512)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (2, 24)).astype(np.int32)
    frames = rng.normal(size=(2, 256, 128)).astype(np.float32)
    jgrow = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]) \
        if a.shape[2] == 23 else a
    tgrow = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1)) \
        if a.shape[2] == 23 else a
    gaps = {}
    for dtype, threshold in (("bfloat16", 256), ("bfloat16", 1 << 20),
                             ("float32", 256)):
        jc = j_get_config(AUDIO).replace(
            act_dtype=dtype, attn_chunk_threshold=threshold, **over)
        jb = j_build_bundle(jc)
        jp = jb.init(jax.random.key(0))
        b = build_bundle(get_config(AUDIO).replace(
            act_dtype=dtype, attn_chunk_threshold=threshold, **over), "cpu")
        p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        j, t = _batches({"frames": frames, "tokens": toks}, dtype)
        jfull, _ = jax.jit(jb.prefill_fn)(jp, j)
        _, jcache = jax.jit(jb.prefill_fn)(
            jp, {**j, "tokens": j["tokens"][:, :-1]})
        jstep, _ = jax.jit(jb.decode_fn)(
            jp, jax.tree.map(jgrow, jcache),
            {"tokens": j["tokens"][:, -1:], "pos": jnp.int32(23)})
        with torch.no_grad():
            full, _ = b.prefill_fn(p, t)
            _, cache = b.prefill_fn(p, {**t, "tokens": t["tokens"][:, :-1]})
            step, _ = b.decode_fn(p, tree_map(tgrow, cache), {
                "tokens": t["tokens"][:, -1:], "pos": 23})
        close(full, jfull, dtype)
        want = float(np.abs(_np(jfull) - _np(jstep)).max())
        got = float((full - step).abs().max())
        gaps[(dtype, threshold)] = (got, want)
        print(f"{dtype} threshold {threshold}: decode-after-prefill gap "
              f"port {got:.4g}, reference {want:.4g}, logit scale "
              f"{float(np.abs(_np(jfull)).max()):.3g}")
    scale = max(1.0, float(full.abs().max()))
    got, want = gaps[("bfloat16", 256)]
    assert want > 0 and abs(got - want) <= BF16_REL * scale
    assert max(gaps[("bfloat16", 1 << 20)]) <= 3e-2
    got, want = gaps[("float32", 256)]
    assert got <= 1e-4 * scale and want <= 1e-4 * scale


# ---------------------------------------------------------------------------
# the session layer
# ---------------------------------------------------------------------------

def _margins(jb, jp, prompt, tokens) -> list:
    """The reference's top-2 logit margin before each generated token,
    from its decode fed token by token."""
    dec = jax.jit(jb.decode_fn)
    cache = jb.empty_cache(1, 32)
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
@pytest.mark.parametrize("arch", ["audio", "vlm"])
def test_service_tokens_match_the_reference(arch, paged):
    """``LMSessionService`` over token prompts (no session entry point
    takes frames or patches: the seamless cross leaves stay zero), fp32:
    ``parallel_safe`` as the reference's (internvl a dense decoder with
    chunked prefill; seamless fed token by token), greedy tokens equal to
    the reference's up to its first near tie, dense and paged."""
    jb, jp, b, p = _pair(arch, "float32")
    kw = dict(n_slots=2, seq_cap=32, t_chunk=4, paged=paged)
    jsvc, svc = JLMService(jb, jp, **kw), LMSessionService(b, p, **kw)
    assert svc.parallel_safe == jsvc.parallel_safe == (arch == "vlm")
    assert svc.paged == jsvc.paged == paged
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, b.cfg.vocab_size, n).astype(np.int32)
               for n in (9, 3)]
    js = [jsvc.open_session(q) for q in prompts]
    ts = [svc.open_session(q) for q in prompts]
    want = jsvc.decode({s: 8 for s in js})
    got = svc.decode({s: 8 for s in ts})
    for q, a, c in zip(prompts, js, ts):
        margins = _margins(jb, jp, q, want[a])
        cut = next((i for i, m in enumerate(margins) if m < 1e-3), 8)
        assert got[c][:cut] == want[a][:cut], (cut, margins)
        assert len(got[c]) == 8


def _audio_svc(**kw):
    _, _, b, p = _pair("audio", "bfloat16")
    return LMSessionService(b, p, **{"n_slots": 2, "seq_cap": 48,
                                     "t_chunk": 8, "max_sessions": 8, **kw})


def _same(a, b) -> bool:
    a, b = tree_leaves(numpy_bits(a)), tree_leaves(numpy_bits(b))
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("paged", [False, True])
def test_encdec_service_invariants(paged):
    """Bit for bit inside the port: t_chunk 1 and 16 against 8, paged
    against dense, a ragged dispatch (a masked lane's column frozen) and
    park/resume through eviction, tokens and every cache leaf; the cross
    leaves stay a dense column per slot when paged."""
    prompts = [np.arange(3, 14, dtype=np.int32), np.array([9, 2], np.int32)]
    ref = _audio_svc()
    r = [ref.open_session(q) for q in prompts]
    want = ref.decode({s: 10 for s in r})
    for kw in ({"t_chunk": 1}, {"t_chunk": 16}, {}):
        svc = _audio_svc(paged=paged, **kw)
        assert svc.paged == paged and not svc.parallel_safe
        if paged:
            assert svc.cache["self"]["cross"]["k"].shape[1] == 2
        s = [svc.open_session(q) for q in prompts]
        got = svc.decode({x: 10 for x in s})
        assert [got[x] for x in s] == [want[x] for x in r]
        for x, y in zip(s, r):
            assert _same(svc.live_column(x), ref.live_column(y))
    # ragged, then park/resume through eviction
    before = svc.live_column(s[0])
    more = svc.decode({s[1]: 3})[s[1]]
    assert _same(svc.live_column(s[0]), before)
    assert more == ref.decode({r[1]: 3})[r[1]]
    extra = svc.open_session(np.array([7], np.int32))
    svc.decode({extra: 2, s[1]: 1})
    assert svc.poll(s[0])["state"] == "parked"
    assert svc.decode({s[0]: 5})[s[0]] == ref.decode({r[0]: 5})[r[0]]


@pytest.mark.parametrize("paged", [False, True])
def test_park_bytes_match_the_reference(paged):
    """The parked footprint: the cross leaves whole (no sequence axis) and
    the self K/V per position, the reference's coefficients; a parked
    blob's bytes are ``kv_park_bytes`` of its rows; at full size 402,653,
    184 fixed and 98,304 a token."""
    jb, jp, b, p = _pair("audio", "bfloat16")
    kw = dict(n_slots=2, seq_cap=48, t_chunk=8, paged=paged)
    jsvc, svc = JLMService(jb, jp, **kw), LMSessionService(b, p, **kw)
    assert (svc._park_fixed, svc._park_per_pos) == \
        (jsvc._park_fixed, jsvc._park_per_pos)
    cfg = b.cfg
    assert svc._park_fixed == 2 * cfg.n_layers * 4096 * cfg.n_kv_heads \
        * cfg.dh * 2
    sid = svc.open_session(np.array([4, 5, 6], np.int32))
    svc.decode({sid: 18})
    steps = svc.sessions[sid].steps
    svc.park(sid)
    size = sum(a.nbytes for a in tree_leaves(svc.parking[sid]["kv"]))
    rows = -(-steps // svc.block_len) * svc.block_len if svc.paged else steps
    assert size == svc.kv_park_bytes(rows)
    full = get_config(AUDIO)
    per_pos = 2 * full.n_layers * full.n_kv_heads * full.dh * 2
    assert (2 * full.n_layers * 4096 * full.n_kv_heads * full.dh * 2,
            per_pos) == (402_653_184, 98_304)


@pytest.mark.parametrize("paged", [False, True])
def test_cross_pass_through_equals_lane_select(paged, monkeypatch):
    """The decode scan passes the cross leaves a step returned untouched
    (the very tensors it was given) through the value mask; a scan that
    ``lane_select``s them instead gives the same tokens and cache bits,
    and the pass-through keeps the grid's cross tensors themselves."""
    prompts = [np.arange(5, 12, dtype=np.int32), np.array([3], np.int32)]

    def run():
        svc = _audio_svc(paged=paged)
        cross = svc.cache["self"]["cross"]["k"]
        s = [svc.open_session(q) for q in prompts]
        out = svc.decode({s[0]: 6})  # ragged: lane 1 masked throughout
        out.update(svc.decode({x: 5 for x in s}))
        return svc, s, out, cross

    svc, s, out, cross = run()
    assert svc.cache["self"]["cross"]["k"] is cross
    selects = []
    orig = lm_mod.lane_select

    def always(valid, new, old, batch_axes, rec):
        return lm_mod.map_tree(
            lambda n, o, bax, r: selects.append(1) or orig(valid, n, o, bax)
            if r else n, new, old, batch_axes, rec)

    monkeypatch.setattr(lm_mod, "mask_recurrent", always)
    svc2, s2, out2, cross2 = run()
    assert selects and svc2.cache["self"]["cross"]["k"] is not cross2
    assert [out2[x] for x in s2] == [out[x] for x in s]
    for x, y in zip(s, s2):
        assert _same(svc.live_column(x), svc2.live_column(y))
    assert _same(svc.cache["self"]["cross"], svc2.cache["self"]["cross"])


def _jbits(tree) -> list:
    return [np.asarray(x).view(np.uint16) if np.asarray(x).dtype.name ==
            "bfloat16" else np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("paged", [False, True])
def test_spill_files_cross_the_packages(paged, tmp_path):
    """bf16 seamless services: the reference's spill file (bf16 self rows
    and the whole cross leaves) restores in the port with the same bits,
    through a resume and a park again, and the port's restores in the
    reference with the same bits."""
    jb, jp, b, p = _pair("audio", "bfloat16")
    kw = dict(n_slots=2, seq_cap=48, t_chunk=8, max_sessions=8, paged=paged)
    jsvc, svc = JLMService(jb, jp, **kw), LMSessionService(b, p, **kw)
    js = jsvc.open_session(np.arange(3, 22, dtype=np.int32))
    jsvc.decode({js: 5})
    jpath = str(tmp_path / "jax.npz")
    jsvc.spill_parking(jpath, include_bound=True)
    jbits = _jbits(jsvc.parking[js])
    bits = lambda: tree_leaves(numpy_bits(svc.parking[js]))
    assert svc.restore_parking(jpath) == [js]
    assert all(np.array_equal(x, y) for x, y in zip(bits(), jbits))
    svc.resume(js)
    svc.park(js)
    assert all(np.array_equal(x, y) for x, y in zip(bits(), jbits))
    assert len(svc.decode({js: 3})[js]) == 3
    ppath = str(tmp_path / "port.npz")
    svc.spill_parking(ppath, include_bound=True)
    fresh = JLMService(jb, jp, **kw)
    assert fresh.restore_parking(ppath) == [js]
    assert all(np.array_equal(x, y)
               for x, y in zip(_jbits(fresh.parking[js]), bits()))


# ---------------------------------------------------------------------------
# few-shot enrollment through the backbones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["audio", "vlm"])
def test_adapt_over_embed_fn(arch):
    """A 5-way 1-shot ``adapt`` over the bundle's ``embed_fn`` (frames or
    patches and 6 tokens a shot), bf16 embeddings upcast to fp32, W and b
    against the reference's ``adapt`` (fp32 parity of the shared
    embeddings: the bf16 tolerance), and the port's W/b against
    ``support_sums`` + ``pn_fc_from_sums`` of its own embeddings at rtol
    1e-5, atol 1e-6."""
    jb, jp, b, p = _pair(arch, "bfloat16")
    cfg = b.cfg
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (5, 6)).astype(
        np.int32), **_front(cfg, rng, 5)}
    labels = np.array([3, 0, 4, 1, 2], np.int32)
    jbatch, tbatch = _batches(batch, "bfloat16")
    jw, jbias = j_protonet.adapt(jb.embed_fn, jp, jbatch,
                                 jnp.asarray(labels), 5, 1, backend="ref")
    with torch.no_grad():
        w, bias = protonet.adapt(b.embed_fn, p, tbatch,
                                 torch.from_numpy(labels), 5, 1)
        emb = b.embed_fn(p, tbatch).float()
    assert w.shape == (5, cfg.d_model) and w.dtype == torch.float32
    close(w, jw, "bfloat16")
    close(bias, jbias, "bfloat16")
    pw, pb = protonet.pn_fc_from_sums(
        protonet.support_sums(emb, torch.from_numpy(labels), 5), 1)
    torch.testing.assert_close(w, pw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bias, pb, rtol=1e-5, atol=1e-6)
