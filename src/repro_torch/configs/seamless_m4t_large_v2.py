"""Assigned architecture config: seamless-m4t-large-v2, field for field as in
``repro/configs/seamless_m4t_large_v2.py``."""

from repro_torch.models.config import ArchConfig

SEAMLESS_M4T_V2 = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",  # [arXiv:2308.11596; hf]
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab_size=256206, norm_type="layernorm",
    mlp_type="relu", frontend="frames", train_microbatch=2,  # speech frontend stub: frame embeds
)

CONFIG = SEAMLESS_M4T_V2
