"""Model bundles: one functional API per architecture family.

The port of ``repro/models/build.py`` for every family of the zoo: the
``tcn`` family, the ``dense`` LM family (olmo-1b, stablelm-1.6b,
qwen2.5-32b, command-r-35b), the ``moe`` family (deepseek-v2-lite-16b
with MLA attention, moonshot-v1-16b-a3b with GQA), the ``vlm`` family
(internvl2-76b: patch embeddings in front of the text), the
encoder-decoder ``audio`` family (seamless-m4t-large-v2: a non-causal
encoder over frame embeddings, cross attention in every decoder layer),
``rwkv`` (rwkv6-1.6b) and the ``hybrid`` Mamba2 stack with one shared
attention block (zamba2-1.2b).  The vlm and audio front ends are the
reference's stubs: the batch carries precomputed embeddings, "patches"
(B, P, D) or "frames" (B, S_enc, D).

A ``Bundle`` carries the config, the param defs, the device its tensors
live on and the functions:

  * TCN: ``loss_fn`` (the train-mode forward and the FC head's
    cross-entropy, what ``training/trainer.py`` differentiates),
    ``prefill_fn`` and ``embed_fn`` (the shot embedder of the PN-as-FC
    head and the session service);
  * LM: ``prefill_fn(params, {"tokens"}) -> (logits_last, cache)``
    (vlm: and "patches", whose positions come first; audio: and
    "frames", run through the encoder),
    ``decode_fn(params, cache, {"tokens" (B, 1), "pos"}) -> (logits
    (B, V), cache)``, ``step_fn`` (the same at (B, S), logits at every
    position: the chunked-prefill step), ``empty_cache(B, S)`` and
    ``cache_specs(B, S)`` (the same shapes on the ``meta`` device), and
    ``embed_fn`` (mean final hidden state over the decoder's positions,
    the front end's batch keys as for the prefill).  The cache is the
    reference's tree: {"dense": …, "moe": …} for the two layer stacks (a
    stack the config lacks is absent), each {"k", "v"} (GQA) or {"c_kv",
    "k_rope"} (MLA); the encoder-decoder's {"self": {"k", "v", "cross":
    {"k", "v"}}}, whose cross leaves an empty cache holds at
    ``ENCDEC_ENC_LEN`` zero rows and a prefill at the frames' length (no
    sequence axis: the session layer carries them whole); RWKV's
    {"x_prev_t", "x_prev_c" (L, B, D), "state" (L, B, H, Dh, Dh) fp32};
    zamba's {"mamba": {"conv" (L, B, K-1, C), "ssm" (L,
    B, H, N, P) fp32}, "attn": {"k", "v"} (n_apps, B, S, Hkv, Dh)}, one
    KV cache per application site of the shared block.  Cached calls
    write position-indexed leaves (K/V rows) in place and return new
    tensors for recurrent leaves, leaving the given ones as they were
    (the session layer masks those by value); ``pos`` is an int, or a
    tensor 0-d or per lane (B,);
  * LM training: ``loss_fn(params, batch) -> (loss, metrics)``, the
    reference's: the batch's "tokens" and "labels" (B, S) (and the front
    end's "patches" or "frames"), the layers under remat (checkpointed,
    ``transformer.scan_layers``; RWKV's layers, zamba's Mamba layers and
    each application of its shared block, each checkpointed as a unit),
    ``chunked_cross_entropy`` over the labels (the vlm's patch positions
    labelled -1), plus ``router_aux_coef * moe_aux`` on a MoE stack;
    metrics {"acc", "tokens"} and the MoE stack's {"moe_aux",
    "moe_dropped"}.  ``training/trainer.py`` differentiates it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.shapes import ENCDEC_ENC_LEN
from repro_torch.kernels.dispatch import require_device
from repro_torch.models import tcn as tcn_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_norm, layernorm, rope_angles
from repro_torch.models.params import ParamDef, init_params
from repro_torch.models.rwkv import (
    rwkv_empty_cache,
    rwkv_layer,
    rwkv_layer_param_defs,
)
from repro_torch.models.ssm import (
    mamba_empty_cache,
    mamba_layer,
    mamba_param_defs,
)
from repro_torch.models.transformer import (
    act_dtype,
    backbone,
    checkpointed,
    chunked_cross_entropy,
    embed_tokens,
    layer_fwd,
    layer_param_defs,
    logits_all,
    logits_last,
    model_param_defs,
    norm_param_defs,
    run_encoder,
    stack_defs,
    stack_sizes,
    unstack_layers,
)


@dataclass
class Bundle:
    cfg: ArchConfig
    param_defs: dict
    device: torch.device
    embed_fn: Callable  # (params, batch, state=None, quantize=False) -> (B, V)
    # TCN: (params, batch, state=None, quantize=False)
    #   -> (loss, ({"acc": acc}, new_state)); LM: (params, batch)
    #   -> (loss, metrics) (module docstring)
    loss_fn: Callable
    prefill_fn: Callable  # TCN: (params, batch) -> (logits, {})
    decode_fn: Callable | None = None   # LM only (module docstring)
    step_fn: Callable | None = None
    empty_cache: Callable | None = None
    cache_specs: Callable | None = None

    def init(self, generator: torch.Generator) -> dict:
        """Seeded params on the bundle's device.  The TCN draws on the CPU
        and moves the tree; an LM tree (1.3 B values at olmo-1b) is drawn
        on the device, so ``generator`` must live there."""
        if self.cfg.family == "tcn":
            return tcn_mod.init_params(self.param_defs, generator,
                                       self.device)
        return init_params(self.param_defs, generator, self.device)


def cross_entropy(logits, labels):
    """(mean of logsumexp - gold logit, accuracy), as the reference's
    TCN loss computes them."""
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return torch.mean(lse - gold), acc


def build_tcn_bundle(cfg: ArchConfig, device="cuda") -> Bundle:
    dev = require_device(device)

    def loss_fn(params, batch, state=None, quantize=False):
        state = state if state is not None \
            else tcn_mod.tcn_empty_state(cfg, dev)
        _, logits, new_state = tcn_mod.tcn_forward(
            params, state, cfg, batch["x"], train=True, quantize=quantize)
        loss, acc = cross_entropy(logits, batch["labels"])
        return loss, ({"acc": acc}, new_state)

    def embed_fn(params, batch, state=None, quantize=False):
        state = state if state is not None \
            else tcn_mod.tcn_empty_state(cfg, dev)
        emb, _, _ = tcn_mod.tcn_forward(params, state, cfg, batch["x"],
                                        quantize=quantize)
        return emb

    def prefill_fn(params, batch):
        state = tcn_mod.tcn_empty_state(cfg, dev)
        _, logits, _ = tcn_mod.tcn_forward(params, state, cfg, batch["x"])
        return logits, {}

    return Bundle(cfg=cfg, param_defs=tcn_mod.tcn_param_defs(cfg),
                  device=dev, embed_fn=embed_fn, loss_fn=loss_fn,
                  prefill_fn=prefill_fn)


# ---------------------------------------------------------------------------
# Transformer LM bundle (dense, MoE, vlm and encoder-decoder families)
# ---------------------------------------------------------------------------

def _kv_cache(cfg, L, B, S, dtype, device) -> dict:
    shape = (L, B, S, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _mla_cache(cfg, L, B, S, dtype, device) -> dict:
    return {"c_kv": torch.zeros((L, B, S, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((L, B, S, 1, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def make_empty_cache(cfg: ArchConfig, B: int, S: int, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    """Zeroed cache: {"dense": …, "moe": …} per layer stack, each GQA's
    {"k", "v"} (L, B, S, Hkv, Dh) or MLA's {"c_kv" (L, B, S, r),
    "k_rope" (L, B, S, 1, dr)}; the encoder-decoder's and the recurrent
    families' trees (module docstring)."""
    if cfg.family == "rwkv":
        return rwkv_empty_cache(cfg, B, dtype, device)
    if cfg.family == "hybrid":
        return {"mamba": mamba_empty_cache(cfg, cfg.n_layers, B, dtype,
                                           device),
                "attn": _kv_cache(cfg, _zamba_n_apps(cfg), B, S, dtype,
                                  device)}
    if cfg.family == "audio":
        c = _kv_cache(cfg, cfg.n_layers, B, S, dtype, device)
        c["cross"] = _kv_cache(cfg, cfg.n_layers, B, ENCDEC_ENC_LEN, dtype,
                               device)
        return {"self": c}
    per = _mla_cache if cfg.use_mla else _kv_cache
    n_moe, n_dense = stack_sizes(cfg)
    out = {}
    if n_dense:
        out["dense"] = per(cfg, n_dense, B, S, dtype, device)
    if n_moe:
        out["moe"] = per(cfg, n_moe, B, S, dtype, device)
    return out


def _as_pos(pos, dev):
    """A cached step's position as a tensor (as the reference's traced
    ``pos``, so ``attention`` never takes the prefill-only chunked path)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(dev, torch.int32)
    return torch.as_tensor(pos, dtype=torch.int32).to(dev)


def _lm_inputs(params, cfg, batch, remat: bool = False):
    """Embed a batch as the reference's ``_lm_inputs_train``: (x (B, S,
    D), labels (B, S), enc_h or None); labels default to the tokens, as
    the reference's ``embed_fn`` fills them.  vlm: the patches in front of
    the text, their labels -1; audio: the encoder over the frames (under
    remat for the loss)."""
    x = embed_tokens(params, cfg, batch["tokens"])
    labels, enc_h = batch.get("labels", batch["tokens"]), None
    if cfg.family == "vlm":
        patches = batch["patches"]
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        pad = torch.full(patches.shape[:2], -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    elif cfg.family == "audio":
        enc_h = run_encoder(params, cfg, batch["frames"], remat=remat)
    return x, labels, enc_h


def build_lm_bundle(cfg: ArchConfig, device="cuda") -> Bundle:
    dev = require_device(device)
    defs = model_param_defs(cfg)
    adt = act_dtype(cfg)

    def loss_fn(params, batch):
        x, labels, enc_h = _lm_inputs(params, cfg, batch, remat=True)
        h, metrics = backbone(params, cfg, x, 0, None, enc_h, remat=True)
        loss, lm_m = chunked_cross_entropy(h, params["lm_head"], labels,
                                           cfg.logit_chunk)
        metrics = {**metrics, **lm_m}
        if "moe_aux" in metrics:
            loss = loss + cfg.router_aux_coef * metrics["moe_aux"]
        return loss, metrics

    def prefill_fn(params, batch):
        x, _, enc_h = _lm_inputs(params, cfg, batch)
        B, S = x.shape[:2]
        if enc_h is None:
            cache = make_empty_cache(cfg, B, S, adt, dev)
        else:  # the cross K/V take the frames' length, not ENCDEC_ENC_LEN
            c = _kv_cache(cfg, cfg.n_layers, B, S, adt, dev)
            c["cross"] = _kv_cache(cfg, cfg.n_layers, B, enc_h.shape[1], adt,
                                   dev)
            cache = {"self": c}
        h, _ = backbone(params, cfg, x, 0, cache, enc_h)
        return logits_last(params, cfg, h), cache

    def step_fn(params, cache, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        h, _ = backbone(params, cfg, x, _as_pos(batch["pos"], dev), cache)
        return logits_all(params, cfg, h), cache

    def decode_fn(params, cache, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        h, _ = backbone(params, cfg, x, _as_pos(batch["pos"], dev), cache)
        return logits_last(params, cfg, h), cache

    def embed_fn(params, batch):
        x, _, enc_h = _lm_inputs(params, cfg, batch)
        return backbone(params, cfg, x, 0, None, enc_h)[0].mean(dim=1)

    return Bundle(
        cfg=cfg, param_defs=defs, device=dev, embed_fn=embed_fn,
        loss_fn=loss_fn, prefill_fn=prefill_fn, decode_fn=decode_fn,
        step_fn=step_fn,
        empty_cache=lambda B, S: make_empty_cache(cfg, B, S, adt, dev),
        cache_specs=lambda B, S: make_empty_cache(cfg, B, S, adt, "meta"))


# ---------------------------------------------------------------------------
# RWKV6 bundle
# ---------------------------------------------------------------------------

def _layer_list(layers) -> list:
    """A stacked layer tree as per-layer views, or a baked list as it is."""
    return unstack_layers(layers) if isinstance(layers, dict) else layers


def _stacked(per_layer: list) -> dict:
    """Per-layer cache dicts -> one dict of (L, ...) stacked leaves."""
    return {k: torch.stack([c[k] for c in per_layer])
            for k in per_layer[0]}


def rwkv_model_param_defs(cfg: ArchConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), init="embed"),
        "ln_in": {"w": ParamDef((D,), ("embed",), init="ones"),
                  "b": ParamDef((D,), ("embed",), init="zeros")},
        "layers": stack_defs(rwkv_layer_param_defs(cfg), cfg.n_layers),
        "final_norm": {"w": ParamDef((D,), ("embed",), init="ones"),
                       "b": ParamDef((D,), ("embed",), init="zeros")},
        "lm_head": ParamDef((D, V), ("embed", "vocab")),
    }


def _rwkv_forward(params, cfg, x, cache, *, remat: bool = False):
    """Input norm, the layers in order, final norm.  Returns (hidden, a new
    cache tree); ``cache`` is not written.  ``remat`` (the loss's call):
    each layer checkpointed, nothing but its inputs kept (the
    reference's ``nothing_saveable``)."""
    x = layernorm(x, params["ln_in"]["w"], params["ln_in"]["b"])

    def body(x, p, c):
        return rwkv_layer(p, cfg, x, c)

    if remat:
        body = checkpointed(body)
    new = []
    for i, p in enumerate(_layer_list(params["layers"])):
        x, c = body(x, p, {k: v[i] for k, v in cache.items()})
        new.append(c)
    x = layernorm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    return x, _stacked(new)


def build_rwkv_bundle(cfg: ArchConfig, device="cuda") -> Bundle:
    dev = require_device(device)
    adt = act_dtype(cfg)

    def loss_fn(params, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        h, _ = _rwkv_forward(params, cfg, x,
                             rwkv_empty_cache(cfg, x.shape[0], x.dtype, dev),
                             remat=True)
        return chunked_cross_entropy(h, params["lm_head"], batch["labels"],
                                     cfg.logit_chunk)

    def prefill_fn(params, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        cache = rwkv_empty_cache(cfg, x.shape[0], x.dtype, dev)
        h, cache = _rwkv_forward(params, cfg, x, cache)
        return logits_last(params, cfg, h), cache

    def step_fn(params, cache, batch):
        # the chunked WKV form: the recurrence reassociated, not bit for bit
        # S decode steps (the session layer prefills these token by token)
        x = embed_tokens(params, cfg, batch["tokens"])
        h, cache = _rwkv_forward(params, cfg, x, cache)
        return logits_all(params, cfg, h), cache

    def decode_fn(params, cache, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        h, cache = _rwkv_forward(params, cfg, x, cache)
        return logits_last(params, cfg, h), cache

    def embed_fn(params, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        h, _ = _rwkv_forward(params, cfg, x,
                             rwkv_empty_cache(cfg, x.shape[0], x.dtype, dev))
        return h.mean(dim=1)

    return Bundle(
        cfg=cfg, param_defs=rwkv_model_param_defs(cfg), device=dev,
        embed_fn=embed_fn, loss_fn=loss_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn, step_fn=step_fn,
        empty_cache=lambda B, S: rwkv_empty_cache(cfg, B, adt, dev),
        cache_specs=lambda B, S: rwkv_empty_cache(cfg, B, adt, "meta"))


# ---------------------------------------------------------------------------
# Zamba2 hybrid bundle (Mamba2 stack + one shared attention block)
# ---------------------------------------------------------------------------

def _zamba_n_apps(cfg: ArchConfig) -> int:
    return -(-cfg.n_layers // cfg.attn_every)


def zamba_model_param_defs(cfg: ArchConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), init="embed"),
        "layers": stack_defs(mamba_param_defs(cfg), cfg.n_layers),
        "shared_attn": layer_param_defs(cfg, moe=False),  # ONE shared block
        "final_norm": norm_param_defs(cfg),
        "lm_head": ParamDef((D, V), ("embed", "vocab")),
    }


def _zamba_forward(params, cfg, x, cache, pos, *, remat: bool = False):
    """The Mamba stack with the shared attention block before each segment
    of ``attn_every`` layers (one set of weights, a KV cache per
    application site).  ``cache`` None: no cache (zero Mamba states, no
    KV).  Returns (hidden, new cache): the Mamba leaves new tensors, the
    KV leaves the given ones, written in place.  ``remat`` (the loss's
    call): each Mamba layer and each application of the shared block
    checkpointed as a unit, nothing but its inputs kept."""
    B, S, _ = x.shape
    ar = torch.arange(S, device=x.device)
    positions = ar + (pos.reshape(-1, 1) if isinstance(pos, torch.Tensor)
                      and pos.dim() else pos)
    rope = rope_angles(positions, int(cfg.dh * cfg.rotary_frac),
                       cfg.rope_theta)
    L, E = cfg.n_layers, cfg.attn_every
    layers = _layer_list(params["layers"])
    mcache = mamba_empty_cache(cfg, L, B, x.dtype, x.device) \
        if cache is None else cache["mamba"]
    def abody(x, ac):
        return layer_fwd(params["shared_attn"], cfg, x, rope, ac, pos)[0]

    def mbody(x, p, c):
        return mamba_layer(p, cfg, x, c)

    if remat:
        abody, mbody = checkpointed(abody), checkpointed(mbody)
    new = []
    for app in range(_zamba_n_apps(cfg)):
        ac = None if cache is None \
            else {k: v[app] for k, v in cache["attn"].items()}
        x = abody(x, ac)
        for i in range(app * E, min((app + 1) * E, L)):
            x, c = mbody(x, layers[i], {k: v[i] for k, v in mcache.items()})
            new.append(c)
    x = apply_norm(cfg.norm_type, params, "final_norm", x)
    if cache is None:
        return x, None
    return x, {"mamba": _stacked(new), "attn": cache["attn"]}


def build_zamba_bundle(cfg: ArchConfig, device="cuda") -> Bundle:
    dev = require_device(device)
    adt = act_dtype(cfg)

    def loss_fn(params, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        h, _ = _zamba_forward(params, cfg, x, None, 0, remat=True)
        return chunked_cross_entropy(h, params["lm_head"], batch["labels"],
                                     cfg.logit_chunk)

    def prefill_fn(params, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        cache = make_empty_cache(cfg, x.shape[0], x.shape[1], adt, dev)
        h, cache = _zamba_forward(params, cfg, x, cache, 0)
        return logits_last(params, cfg, h), cache

    def step_fn(params, cache, batch):
        # chunked SSD: reassociated against ssd_step, as RWKV's step_fn
        x = embed_tokens(params, cfg, batch["tokens"])
        h, cache = _zamba_forward(params, cfg, x, cache,
                                  _as_pos(batch["pos"], dev))
        return logits_all(params, cfg, h), cache

    def decode_fn(params, cache, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        h, cache = _zamba_forward(params, cfg, x, cache,
                                  _as_pos(batch["pos"], dev))
        return logits_last(params, cfg, h), cache

    def embed_fn(params, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        return _zamba_forward(params, cfg, x, None, 0)[0].mean(dim=1)

    return Bundle(
        cfg=cfg, param_defs=zamba_model_param_defs(cfg), device=dev,
        embed_fn=embed_fn, loss_fn=loss_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn, step_fn=step_fn,
        empty_cache=lambda B, S: make_empty_cache(cfg, B, S, adt, dev),
        cache_specs=lambda B, S: make_empty_cache(cfg, B, S, adt, "meta"))


BUILDERS = {
    "tcn": build_tcn_bundle,
    "dense": build_lm_bundle,
    "moe": build_lm_bundle,
    "vlm": build_lm_bundle,
    "audio": build_lm_bundle,
    "rwkv": build_rwkv_bundle,
    "hybrid": build_zamba_bundle,
}


def build_bundle(cfg: ArchConfig, device="cuda") -> Bundle:
    if cfg.family not in BUILDERS:
        raise ValueError(f"unknown family {cfg.family!r}")
    return BUILDERS[cfg.family](cfg, device)
