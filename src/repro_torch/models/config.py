"""Architecture configuration shared by every model family.

A copy of ``repro.models.config.ArchConfig``: the port imports nothing of
the JAX package, and the field names and defaults stay identical so one
configuration describes the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | rwkv | hybrid | vlm | audio | tcn
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 256
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"  # swiglu | gelu | relu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_np
    qkv_bias: bool = False
    mlp_bias: bool = False
    parallel_block: bool = False  # command-r style fused attn+FFN residual
    # GQA with n_kv_heads < TP degree: repeat KV to full heads so the head
    # dim shards cleanly (Megatron's duplication rule, lifted to activations)
    attn_kv_repeat: bool = False
    rope_theta: float = 1e6
    rotary_frac: float = 1.0
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_topk: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # dense FFN in first layer(s) (deepseek-v2 uses dense layer 0)
    n_dense_layers: int = 0

    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # decode-time weight absorption: attend in the latent space instead of
    # up-projecting K/V for the whole context every step (§Perf lever)
    mla_absorb: bool = False

    # --- RWKV6 ---
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # --- Mamba2 / hybrid (zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_k: int = 4
    attn_every: int = 0  # hybrid: shared attention block period (0 = none)

    # --- enc-dec (seamless) ---
    n_enc_layers: int = 0

    # --- modality frontend stubs ---
    frontend: str = "none"  # none | patch | frames
    n_patches: int = 1024   # vlm: patches prepended to the text sequence

    # --- TCN (the paper's arch) ---
    tcn_kernel: int = 0
    tcn_channels: tuple = ()
    tcn_in_channels: int = 1
    embed_dim: int = 64       # PN embedding size V
    act_scale: float = 0.25   # fixed u4 activation scale (QAT + streaming)
    n_classes: int = 12       # inference FC head (rewritten by PN learning)

    # --- numerics / execution ---
    # kernel backend for the fused fast path (kernels/dispatch.py):
    # auto | cuda | ref — resolved once at op construction;
    # REPRO_TORCH_KERNEL_BACKEND overrides "auto"
    kernel_backend: str = "auto"
    act_dtype: str = "bfloat16"
    logit_chunk: int = 512      # chunked cross-entropy seq chunk
    attn_chunk_threshold: int = 4096  # flash-chunked attention above this
    # microbatch gradient accumulation for train_4k (memory roofline knob;
    # also the compute/comm overlap unit — see trainer.py)
    train_microbatch: int = 1
    remat_policy: str = "nothing"  # nothing | dots
    scan_layers: bool = True

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 4),
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 2),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 128),
            vocab_size=min(self.vocab_size, 512),
            head_dim=32 if self.dh >= 32 else self.dh,
            logit_chunk=64,
        )
        if self.n_experts:
            kw.update(
                n_experts=min(self.n_experts, 4),
                moe_topk=min(self.moe_topk, 2),
                d_ff_expert=min(self.d_ff_expert, 64),
                n_shared_experts=min(self.n_shared_experts, 1),
                # drop-free in smoke tests: capacity drops are position-
                # dependent, which would confound cache-consistency checks
                capacity_factor=64.0,
            )
        if self.use_mla:
            kw.update(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, attn_every=self.attn_every and 2)
        if self.n_enc_layers:
            kw.update(n_enc_layers=2)
        if self.frontend == "patch":
            kw.update(n_patches=8)
        if self.tcn_channels:
            kw.update(tcn_channels=tuple(min(c, 16) for c in self.tcn_channels[:3]),
                      tcn_kernel=min(self.tcn_kernel, 3), embed_dim=16)
        return self.replace(**kw)
