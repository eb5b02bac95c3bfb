"""Assigned architecture config: internvl2-76b, field for field as in
``repro/configs/internvl2_76b.py``."""

from repro_torch.models.config import ArchConfig

INTERNVL2_76B = ArchConfig(
    name="internvl2-76b", family="vlm",  # [arXiv:2404.16821]
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128, attn_kv_repeat=True, train_microbatch=4,
    d_ff=28672, vocab_size=128256, norm_type="rmsnorm", mlp_type="swiglu",
    frontend="patch", n_patches=1024,  # InternViT stub: precomputed patch embeds
)

CONFIG = INTERNVL2_76B
