"""Analytic FLOP / HBM-byte counters per (arch x shape), the port of
``repro/launch/analytic.py``.

The reference counts analytically because XLA's HloCostAnalysis counts a
while-loop body once; the port keeps the same formulas so its counts are
the reference's for every config and shape (standard dense-algebra op
counts, 2 flops per MAC).  A train step's MFU is ``model_flops`` over its
time and a chip's peak (``core/costmodel.py``); the hardware-FLOP share
uses ``flops_global``, the forward times ``_train_mult``.

Conventions: counts are GLOBAL (whole step); causal attention scores
average S/2 keys per query; the train multiplier is fwd + bwd (2x) +
full-remat recompute (1x) = 4x forward flops (remat_policy="dots" saves
the recompute on matmuls: 3x + attention extras).

``count_cell`` takes a shape name of ``configs/shapes.SHAPES`` or a
``ShapeSpec``, so a run can count its own (batch, seq).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.shapes import ENCDEC_ENC_LEN, SHAPES, ShapeSpec
from repro_torch.models.build import _zamba_n_apps
from repro_torch.models.config import ArchConfig
from repro_torch.models.rwkv import CHUNK as RWKV_CHUNK
from repro_torch.models.ssm import CHUNK as SSM_CHUNK
from repro_torch.utils.trees import tree_leaves

# ---------------------------------------------------------------------------
# Parameter counts (exact, from the ParamDef tree)
# ---------------------------------------------------------------------------

def param_count(defs) -> int:
    """Values in a ParamDef tree (``models/params.ParamDef`` or the TCN's)."""
    total = 0
    for d in tree_leaves(defs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total


def active_param_count(cfg: ArchConfig, defs) -> int:
    """MoE: only topk/E of routed-expert params are active per token."""
    total = param_count(defs)
    if not cfg.n_experts:
        return total
    n_moe_layers = cfg.n_layers - cfg.n_dense_layers
    routed = n_moe_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff_expert
    active_routed = routed * cfg.moe_topk / cfg.n_experts
    return int(total - routed + active_routed)


# ---------------------------------------------------------------------------
# Per-layer forward FLOPs (per token unless stated)
# ---------------------------------------------------------------------------

def _attn_flops_tok(cfg: ArchConfig, kv_len: float) -> float:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    if cfg.use_mla:
        dn, dr, dv, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
        proj = 2 * D * (H * (dn + dr)) + 2 * D * (r + dr) \
            + 2 * r * H * (dn + dv) * (kv_len and 1)  # ukv recompute: see below
        # NOTE decode recomputes k/v from the latent for the whole context:
        # that term is kv_len-dependent and added in decode accounting.
        scores = 2 * kv_len * H * (dn + dr) + 2 * kv_len * H * dv
        out = 2 * (H * dv) * D
        return proj + scores + out
    proj = 2 * D * H * Dh + 2 * 2 * D * Hkv * Dh
    scores = 2 * kv_len * H * Dh * 2
    out = 2 * H * Dh * D
    return proj + scores + out


def _mlp_flops_tok(cfg: ArchConfig) -> float:
    mats = 3 if cfg.mlp_type == "swiglu" else 2
    return mats * 2 * cfg.d_model * cfg.d_ff


def _moe_flops_tok(cfg: ArchConfig) -> float:
    f = 2 * cfg.d_model * cfg.n_experts  # router
    f += cfg.moe_topk * 3 * 2 * cfg.d_model * cfg.d_ff_expert
    f += cfg.n_shared_experts * 3 * 2 * cfg.d_model * cfg.d_ff_expert
    return f


def _rwkv_flops_tok(cfg: ArchConfig) -> float:
    D, F = cfg.d_model, cfg.d_ff
    Dh = cfg.rwkv_head_dim
    H = D // Dh
    R = cfg.rwkv_decay_lora
    C = RWKV_CHUNK
    proj = 5 * 2 * D * D + 2 * D * R + 2 * R * D   # r,k,v,g,o + decay LoRA
    wkv = H * (4 * C * Dh + 6 * Dh * Dh)           # chunked intra + state
    chan = 2 * 2 * D * F + 2 * D * D
    return proj + wkv + chan


def _mamba_flops_tok(cfg: ArchConfig) -> float:
    D = cfg.d_model
    di = cfg.ssm_expand * D
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = di // P
    C = SSM_CHUNK
    conv_dim = di + 2 * N
    proj = 2 * D * (2 * di + 2 * N + H)
    conv = 2 * conv_dim * cfg.ssm_conv_k
    ssd = H * (2 * C * (N + P) + 4 * N * P)
    out = 2 * di * D
    return proj + conv + ssd + out


def _tcn_flops_tok(cfg: ArchConfig) -> float:
    k = cfg.tcn_kernel
    f = 0.0
    c_in = cfg.tcn_in_channels
    for c in cfg.tcn_channels:
        f += 2 * k * (c_in * c + c * c)
        if c_in != c:
            f += 2 * c_in * c
        c_in = c
    return f


def layer_fwd_flops_tok(cfg: ArchConfig, kv_len: float, moe_layer: bool) -> float:
    if cfg.family == "rwkv":
        return _rwkv_flops_tok(cfg)
    if cfg.family == "hybrid":
        return _mamba_flops_tok(cfg)
    f = _attn_flops_tok(cfg, kv_len)
    f += _moe_flops_tok(cfg) if moe_layer else _mlp_flops_tok(cfg)
    return f


# ---------------------------------------------------------------------------
# Whole-step global FLOPs per (cfg, shape)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Counts:
    flops_global: float      # whole step, all chips
    bytes_global: float      # HBM traffic estimate, all chips
    model_flops: float       # 6 * N_active * tokens (train) or 2*N*tokens
    n_params: int
    n_params_active: int


def _train_mult(cfg: ArchConfig) -> float:
    return 4.0 if cfg.remat_policy == "nothing" else 3.2


def count_cell(cfg: ArchConfig, defs, shape_name: str | ShapeSpec,
               param_bytes: int = 4) -> Counts:
    s = shape_name if isinstance(shape_name, ShapeSpec) \
        else SHAPES[shape_name]
    B, S = s.global_batch, s.seq_len
    N = param_count(defs)
    Na = active_param_count(cfg, defs)
    V, D, L = cfg.vocab_size, cfg.d_model, cfg.n_layers

    if cfg.family == "tcn":
        T = B * S
        fwd = T * _tcn_flops_tok(cfg)
        mult = _train_mult(cfg) if s.kind == "train" else 1.0
        return Counts(fwd * mult, N * 4 * 10, 6.0 * N * T, N, N)

    if s.kind == "train":
        if cfg.family == "audio":
            T_dec = B * (S // 2)
            T_enc = B * (S // 2)
            fwd = T_enc * cfg.n_enc_layers * layer_fwd_flops_tok(cfg, S // 4, False)
            fwd += T_dec * L * (layer_fwd_flops_tok(cfg, S // 4, False)
                                + _attn_flops_tok(cfg, S // 2))  # + cross
            T_loss = T_dec
        else:
            T = B * S
            n_moe = L - cfg.n_dense_layers if cfg.n_experts else 0
            fwd = T * (L - n_moe) * layer_fwd_flops_tok(cfg, S / 2, False)
            fwd += T * n_moe * layer_fwd_flops_tok(cfg, S / 2, True)
            if cfg.family == "hybrid":
                fwd += T * _zamba_n_apps(cfg) * (
                    _attn_flops_tok(cfg, S / 2) + _mlp_flops_tok(cfg))
            T_loss = T
        fwd += 2.0 * T_loss * D * V  # lm head
        flops = fwd * _train_mult(cfg)
        # HBM bytes: params fp32 {read fwd+bwd+remat, grad w+r, adam m/v r+w,
        # param w} ~ 10x + saved activations 2x r/w + logits chunks
        act_bytes = L * B * S * D * 2 * 2
        bytes_ = N * 4 * 10 + act_bytes + 2 * T_loss * V * 4 / 16  # V sharded
        model_flops = 6.0 * Na * T_loss
        return Counts(flops, bytes_, model_flops, N, Na)

    if s.kind == "prefill":
        if cfg.family == "audio":
            T = B * S
            fwd = B * ENCDEC_ENC_LEN * cfg.n_enc_layers * \
                layer_fwd_flops_tok(cfg, ENCDEC_ENC_LEN / 2, False)
            fwd += T * L * (layer_fwd_flops_tok(cfg, S / 2, False)
                            + _attn_flops_tok(cfg, ENCDEC_ENC_LEN))
        else:
            T = B * S
            n_moe = L - cfg.n_dense_layers if cfg.n_experts else 0
            fwd = T * (L - n_moe) * layer_fwd_flops_tok(cfg, S / 2, False)
            fwd += T * n_moe * layer_fwd_flops_tok(cfg, S / 2, True)
            if cfg.family == "hybrid":
                fwd += T * _zamba_n_apps(cfg) * (
                    _attn_flops_tok(cfg, S / 2) + _mlp_flops_tok(cfg))
        fwd += 2.0 * B * D * V  # last-position logits
        cache_bytes = _cache_bytes(cfg, B, S)
        bytes_ = N * param_bytes + cache_bytes + B * S * D * 2 * 2 * L
        return Counts(fwd, bytes_, 2.0 * Na * B * S, N, Na)

    # decode: one token, kv_len = S context
    T = B
    if cfg.family == "rwkv":
        f_tok = _rwkv_flops_tok(cfg) - 0  # state update is O(1) in S
        fwd = T * L * f_tok
    elif cfg.family == "hybrid":
        fwd = T * L * _mamba_flops_tok(cfg)
        fwd += T * _zamba_n_apps(cfg) * (
            _attn_flops_tok(cfg, S) + _mlp_flops_tok(cfg))
    else:
        n_moe = L - cfg.n_dense_layers if cfg.n_experts else 0
        fwd = T * (L - n_moe) * layer_fwd_flops_tok(cfg, S, False)
        fwd += T * n_moe * layer_fwd_flops_tok(cfg, S, True)
        if cfg.use_mla:
            if cfg.mla_absorb:
                # absorbed decode: scores+context directly in latent space
                fwd += T * L * (2 * 2 * S * cfg.kv_lora_rank * cfg.n_heads
                                + 2 * cfg.n_heads * cfg.kv_lora_rank
                                * (cfg.qk_nope_dim + cfg.v_head_dim))
            else:
                # baseline decode up-projects the latent for the full context
                fwd += T * L * 2 * S * cfg.kv_lora_rank * cfg.n_heads * \
                    (cfg.qk_nope_dim + cfg.v_head_dim)
        if cfg.family == "audio":
            fwd += T * L * _attn_flops_tok(cfg, ENCDEC_ENC_LEN)
    fwd += 2.0 * T * D * V
    cache_bytes = _cache_bytes(cfg, B, S)
    bytes_ = N * param_bytes + cache_bytes  # read params + read cache
    return Counts(fwd, bytes_, 2.0 * Na * T, N, Na)


def _cache_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    if cfg.family == "rwkv":
        D = cfg.d_model
        H = D // cfg.rwkv_head_dim
        return cfg.n_layers * B * (2 * D * 2 + H * cfg.rwkv_head_dim ** 2 * 4)
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * cfg.d_model
        H = di // cfg.ssm_head_dim
        ssm = cfg.n_layers * B * (H * cfg.ssm_state * cfg.ssm_head_dim * 4
                                  + (cfg.ssm_conv_k - 1) * (di + 2 * cfg.ssm_state) * 2)
        attn = _zamba_n_apps(cfg) * B * S * 2 * cfg.n_kv_heads * cfg.dh * 2
        return ssm + attn
    if cfg.use_mla:
        per_tok = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.dh * 2
    cache = cfg.n_layers * B * S * per_tok
    if cfg.family == "audio":
        cache += cfg.n_layers * B * ENCDEC_ENC_LEN * 2 * cfg.n_kv_heads * cfg.dh * 2
    return cache
