"""Assigned architecture config: command-r-35b, field for field as in
``repro/configs/command_r_35b.py``."""

from repro_torch.models.config import ArchConfig

COMMAND_R_35B = ArchConfig(
    name="command-r-35b", family="dense",  # [hf:CohereForAI/c4ai-command-r-v01]
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128, attn_kv_repeat=True, train_microbatch=2,
    d_ff=22528, vocab_size=256000, norm_type="layernorm",
    parallel_block=True, mlp_type="swiglu", tie_embeddings=True,
    rope_theta=8e6,
)

CONFIG = COMMAND_R_35B
