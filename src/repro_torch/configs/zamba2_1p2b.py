"""Assigned architecture config: zamba2-1.2b, field for field as in
``repro/configs/zamba2_1p2b.py``."""

from repro_torch.models.config import ArchConfig

ZAMBA2_1B2 = ArchConfig(
    name="zamba2-1.2b", family="hybrid",  # [arXiv:2411.15242; hf]
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, norm_type="rmsnorm",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_k=4,
    attn_every=6, train_microbatch=2,  # one *shared* attention+MLP block applied every 6 layers
)

CONFIG = ZAMBA2_1B2
