"""Assigned architecture config: stablelm-1.6b, field for field as in
``repro/configs/stablelm_1p6b.py``."""

from repro_torch.models.config import ArchConfig

STABLELM_1B6 = ArchConfig(
    name="stablelm-1.6b", family="dense",  # [hf:stabilityai/stablelm-2-1_6b]
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352, norm_type="layernorm",
    mlp_type="swiglu", rotary_frac=0.25, rope_theta=10000.0,
)

CONFIG = STABLELM_1B6
