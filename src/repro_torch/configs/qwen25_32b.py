"""Assigned architecture config: qwen2.5-32b, field for field as in
``repro/configs/qwen25_32b.py``."""

from repro_torch.models.config import ArchConfig

QWEN25_32B = ArchConfig(
    name="qwen2.5-32b", family="dense",  # [hf:Qwen/Qwen2.5-32B]
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, attn_kv_repeat=True, train_microbatch=2,
    d_ff=27648, vocab_size=152064, norm_type="rmsnorm",
    mlp_type="swiglu", qkv_bias=True, rope_theta=1e6,
)

CONFIG = QWEN25_32B
