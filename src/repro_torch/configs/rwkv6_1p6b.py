"""Assigned architecture config: rwkv6-1.6b, field for field as in
``repro/configs/rwkv6_1p6b.py``."""

from repro_torch.models.config import ArchConfig

RWKV6_1B6 = ArchConfig(
    name="rwkv6-1.6b", family="rwkv",  # [arXiv:2404.05892]
    n_layers=24, d_model=2048, d_ff=7168, vocab_size=65536,
    n_heads=32, n_kv_heads=32, head_dim=64,  # 2048/64 WKV heads
    norm_type="layernorm", rwkv_head_dim=64,
)

CONFIG = RWKV6_1B6
