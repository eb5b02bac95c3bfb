"""The dense LM family of the port against the JAX reference, on the CPU:
norms, rotary embeddings (rotary_frac 0.25 and 1.0), dense and chunked
attention (GQA, causal offsets, per-lane cache lengths, a small
``chunked_threshold`` so the chunked path runs), the three MLPs, then
``prefill_fn``/``decode_fn``/``step_fn`` of ``build_bundle`` for the
``smoke()`` cut of every dense config on converted params.

The same seeded numpy inputs go through both packages.  Tolerances: at
fp32, rtol 1e-4 and atol 1e-5 x max(1, max|want|); at bf16 (the
activation dtype the configs serve at), max|got - want| <= 5e-2 x max(1,
max|want|): bf16 keeps 8 mantissa bits and the two packages round their
elementwise chains in different places."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.params import init_params, param_count  # noqa: E402
from repro_torch.models.transformer import bake_lm_params  # noqa: E402

DENSE = ["olmo-1b", "stablelm-1.6b", "qwen2.5-32b", "command-r-35b"]
BF16_REL = 5e-2


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _t(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def close(got, want, dtype="float32"):
    got, want = _t(got).astype(np.float32), _np(want).astype(np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        assert float(np.abs(got - want).max(initial=0.0)) \
            <= BF16_REL * scale


def _pair(a, dtype):
    """One numpy array as (jnp, torch) of ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 48)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=48).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    jx, tx = _pair(x, dtype)
    close(tl.rmsnorm(tx, torch.from_numpy(w)), jl.rmsnorm(jx, jnp.asarray(w)),
          dtype)
    close(tl.layernorm(tx, torch.from_numpy(w), torch.from_numpy(b)),
          jl.layernorm(jx, jnp.asarray(w), jnp.asarray(b)), dtype)
    close(tl.layernorm_np(tx), jl.layernorm_np(jx), dtype)
    assert tl.rmsnorm(tx, torch.from_numpy(w)).dtype == tx.dtype


@pytest.mark.parametrize("rotary_frac", [0.25, 1.0])
@pytest.mark.parametrize("per_lane", [False, True])
def test_rope(rotary_frac, per_lane):
    rng = np.random.default_rng(1)
    dh = 32
    x = rng.normal(size=(2, 6, 3, dh)).astype(np.float32)
    dim = int(dh * rotary_frac)
    pos = (np.array([[3], [11]]) + np.arange(6)) if per_lane \
        else 7 + np.arange(6)
    jc, js = jl.rope_angles(jnp.asarray(pos), dim, 1e4)
    c, s = tl.rope_angles(torch.from_numpy(pos), dim, 1e4)
    close(c, jc)
    close(s, js)
    if per_lane:  # the reference rotates one lane at a time (vmap of B=1)
        want = np.concatenate([np.asarray(jl.apply_rope(
            jnp.asarray(x[i:i + 1]), jc[i], js[i])) for i in range(2)])
    else:
        want = jl.apply_rope(jnp.asarray(x), jc, js)
    close(tl.apply_rope(torch.from_numpy(x), c, s, rotary_frac), want)


def _qkv(rng, b, sq, skv, hq, hkv, dh):
    return (rng.normal(size=(b, sq, hq, dh)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hkv", [4, 1])
def test_attention_dense(dtype, hkv):
    """Causal with an offset and a cache length, GQA grouping, and the
    per-lane form (q_offset/kv_len (B,)) against the reference lane by
    lane."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 3, 12, 4, hkv, 16)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jl.attention_dense(jq, jk, jv, causal=True, q_offset=5, kv_len=8)
    got = tl.attention_dense(tq, tk, tv, causal=True, q_offset=5, kv_len=8)
    close(got, want, dtype)
    assert got.dtype == tq.dtype
    close(tl.attention_dense(tq, tk, tv, causal=False),
          jl.attention_dense(jq, jk, jv, causal=False), dtype)
    off = torch.tensor([2, 7], dtype=torch.int32)
    got = tl.attention_dense(tq, tk, tv, causal=True, q_offset=off,
                             kv_len=off + 3)
    want = np.concatenate([_np(jl.attention_dense(
        jq[i:i + 1], jk[i:i + 1], jv[i:i + 1], causal=True,
        q_offset=int(off[i]), kv_len=int(off[i]) + 3)) for i in range(2)])
    close(got, want, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_chunked(causal):
    """The flash-chunked path (several KV chunks, the last one padded), and
    the dispatcher routing there below a small ``chunked_threshold``."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 21, 21, 4, 2, 16)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    close(tl.attention_chunked(tq, tk, tv, causal=causal, kv_chunk=8),
          jl.attention_chunked(jq, jk, jv, causal=causal, kv_chunk=8))
    close(tl.attention(tq, tk, tv, causal=causal, chunked_threshold=16),
          jl.attention(jq, jk, jv, causal=causal, chunked_threshold=16))
    # chunked and dense agree on the same inputs
    close(tl.attention(tq, tk, tv, causal=causal, chunked_threshold=16),
          tl.attention_dense(tq, tk, tv, causal=causal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu", "relu"])
def test_mlps(kind, dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    p = {"wi": rng.normal(size=(16, 40)) / 4, "wd": rng.normal(size=(40, 16)) / 6}
    if kind == "swiglu":
        p["wg"] = rng.normal(size=(16, 40)) / 4
    else:
        p["bi"], p["bd"] = rng.normal(size=40), rng.normal(size=16)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jx, tx = _pair(x, dtype)
    got = tl.MLP_FNS[kind]({k: torch.from_numpy(v) for k, v in p.items()}, tx)
    want = jl.MLP_FNS[kind]({k: jnp.asarray(v) for k, v in p.items()}, jx)
    close(got, want, dtype)


# ---------------------------------------------------------------------------
# bundles of the four dense configs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bundles(name: str, dtype: str):
    jcfg = j_get_config(name).smoke().replace(act_dtype=dtype)
    cfg = get_config(name).smoke().replace(act_dtype=dtype)
    assert jcfg == jcfg.replace(**{f: getattr(cfg, f) for f in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "head_dim", "norm_type", "mlp_type", "qkv_bias",
        "parallel_block", "attn_kv_repeat", "rope_theta", "rotary_frac")})
    jb = j_build_bundle(jcfg)
    jp = jb.init(jax.random.key(0))
    b = build_bundle(cfg, "cpu")
    return jb, jp, b, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(rng, cfg, shape):
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _cache_close(got, want, dtype):
    for key in ("k", "v"):
        close(got["dense"][key], want["dense"][key], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_bundle_prefill_decode_step(name, dtype):
    """prefill_fn's last logits and cache, step_fn over a chunk at an
    offset, decode_fn at a shared position and at per-lane positions
    (against the reference's decode run lane by lane at B=1)."""
    jb, jp, b, p = _bundles(name, dtype)
    assert set(p) == set(jp) and param_count(b.param_defs) == sum(
        x.size for x in jax.tree.leaves(jp))
    rng = np.random.default_rng(5)
    cfg = b.cfg
    toks = _tokens(rng, cfg, (2, 9))
    jl_, jc = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        lg, c = b.prefill_fn(p, {"tokens": torch.from_numpy(toks)})
    close(lg, jl_, dtype)
    _cache_close(c, jc, dtype)

    # step_fn: a 5-token chunk at position 4 of a 16-row cache holding
    # the first 4 prompt tokens
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

    # decode_fn at one position for both lanes
    nxt = _tokens(rng, cfg, (2, 1))
    jd, jcache = jb.decode_fn(jp, jcache, {"tokens": jnp.asarray(nxt),
                                           "pos": jnp.int32(9)})
    with torch.no_grad():
        d, cache = b.decode_fn(p, cache, {"tokens": torch.from_numpy(nxt),
                                          "pos": torch.tensor(9)})
    close(d, jd, dtype)
    _cache_close(cache, jcache, dtype)

    # per-lane positions: lane 0 at 10, lane 1 at 6 (rewriting its row 6)
    pos = np.array([10, 6], np.int32)
    with torch.no_grad():
        d, cache = b.decode_fn(p, cache, {"tokens": torch.from_numpy(nxt),
                                          "pos": torch.from_numpy(pos)})
    for i in range(2):
        lane = jax.tree.map(lambda a: a[:, i:i + 1], jcache)
        jd_i, lane = jb.decode_fn(jp, lane, {
            "tokens": jnp.asarray(nxt[i:i + 1]), "pos": jnp.int32(pos[i])})
        close(d[i:i + 1], jd_i, dtype)
        _cache_close({"dense": {k: v[:, i:i + 1] for k, v in
                                cache["dense"].items()}}, lane, dtype)


@pytest.mark.parametrize("name", DENSE)
def test_embed_fn_and_cache_specs(name):
    jb, jp, b, p = _bundles(name, "float32")
    toks = _tokens(np.random.default_rng(6), b.cfg, (2, 7))
    with torch.no_grad():
        got = b.embed_fn(p, {"tokens": torch.from_numpy(toks)})
    close(got, jb.embed_fn(jp, {"tokens": jnp.asarray(toks)}))
    spec = b.cache_specs(3, 24)["dense"]["k"]
    want = jb.cache_specs(3, 24)["dense"]["k"]
    assert spec.device.type == "meta" and tuple(spec.shape) == want.shape


def test_baked_tree_is_the_per_use_cast():
    """bake_lm_params casts every leaf once: the same bits as the
    reference's cast at each use, and decode on the baked tree equals
    decode on the fp32 tree bit for bit."""
    _, _, b, p = _bundles("qwen2.5-32b", "bfloat16")
    baked = bake_lm_params(p, b.cfg)
    assert len(baked["layers"]) == b.cfg.n_layers
    for key, w in p["layers"]["attn"].items():
        for i in range(b.cfg.n_layers):
            assert torch.equal(baked["layers"][i]["attn"][key],
                               w[i].to(torch.bfloat16))
    assert bake_lm_params(baked, b.cfg)["embed"] is baked["embed"]
    toks = torch.tensor([[3], [5]], dtype=torch.int32)
    with torch.no_grad():
        a, _ = b.decode_fn(p, b.empty_cache(2, 8), {"tokens": toks, "pos": 0})
        c, _ = b.decode_fn(baked, b.empty_cache(2, 8),
                           {"tokens": toks, "pos": 0})
    assert torch.equal(a, c)


def test_init_params_seeded_on_device():
    cfg = get_config("olmo-1b").smoke()
    b = build_bundle(cfg, "cpu")
    p1 = init_params(b.param_defs, torch.Generator().manual_seed(3), "cpu")
    p2 = b.init(torch.Generator().manual_seed(3))
    assert torch.equal(p1["layers"]["attn"]["wq"], p2["layers"]["attn"]["wq"])
    assert p1["embed"].dtype == torch.float32
    assert float(p1["embed"].std()) == pytest.approx(0.02, rel=0.2)
    assert tuple(p1["layers"]["mlp"]["wd"].shape) == (
        cfg.n_layers, cfg.d_ff, cfg.d_model)


@pytest.mark.parametrize("name", [
    "rwkv6-1.6b", "zamba2-1.2b", "internvl2-76b", "seamless-m4t-large-v2"])
def test_other_families_build_and_train(name):
    """Every config is data, field for field the reference's, and every
    family builds, none refused (the recurrent families, the vlm and the
    encoder-decoder audio family), with the reference's cache tree shapes
    and dtypes at full size; and every family trains: its ``smoke()``
    bundle's ``loss_fn`` gives a finite loss with ``acc`` and ``tokens``
    (held to the reference in ``tests/test_torch_lm_train*.py``)."""
    cfg = get_config(name)
    assert cfg == cfg.replace(**{k: v for k, v in vars(
        j_get_config(name)).items()})
    b = build_bundle(cfg, "cpu")
    got = b.cache_specs(8, 1024)
    want = j_build_bundle(j_get_config(name)).cache_specs(8, 1024)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: not isinstance(x, dict))[0]
    assert [(jax.tree_util.keystr(k), tuple(v.shape),
             str(v.dtype).split(".")[-1]) for k, v in flat(got)] == \
        [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype))
         for k, v in flat(want)]
    small = get_config(name).smoke()
    sb = build_bundle(small, "cpu")
    rng = np.random.default_rng(0)
    S = 16
    batch = {"tokens": rng.integers(0, small.vocab_size, (2, S)),
             "labels": rng.integers(0, small.vocab_size, (2, S))}
    if small.family == "vlm":
        batch["patches"] = rng.normal(size=(2, small.n_patches,
                                            small.d_model))
    if small.family == "audio":
        batch["frames"] = rng.normal(size=(2, S, small.d_model))
    with torch.no_grad():
        loss, metrics = sb.loss_fn(
            sb.init(torch.Generator().manual_seed(0)),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert 0.0 <= float(metrics["acc"]) <= 1.0
    assert float(metrics["tokens"]) == 2 * S


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "moonshot-v1-16b-a3b"])
def test_moe_configs_equal_the_reference_and_build(name):
    """The MoE configs are the reference's field for field and build at
    full size: the same parameter count and the same cache tree shapes
    ({"dense", "moe"} stacks; MLA's latent leaves for deepseek)."""
    from repro.launch.analytic import param_count as j_param_count

    cfg = get_config(name)
    assert cfg == cfg.replace(**{k: v for k, v in vars(
        j_get_config(name)).items()})
    b, jb = build_bundle(cfg, "cpu"), j_build_bundle(j_get_config(name))
    assert param_count(b.param_defs) == j_param_count(jb.param_defs)
    got = {k: {kk: tuple(v.shape) for kk, v in leaves.items()}
           for k, leaves in b.cache_specs(2, 64).items()}
    want = jax.tree.map(lambda s: tuple(s.shape), jb.cache_specs(2, 64))
    assert got == want and set(got) == {"dense", "moe"}
