"""Assigned architecture config: olmo-1b, field for field as in
``repro/configs/olmo_1b.py``."""

from repro_torch.models.config import ArchConfig

OLMO_1B = ArchConfig(
    name="olmo-1b", family="dense",  # [arXiv:2402.00838; hf]
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304, norm_type="layernorm_np",  # non-parametric LN
    mlp_type="swiglu", rope_theta=10000.0,
)

CONFIG = OLMO_1B
