"""Assigned architecture config: deepseek-v2-lite-16b, field for field as in
``repro/configs/deepseek_v2_lite_16b.py``."""

from repro_torch.models.config import ArchConfig

DEEPSEEK_V2_LITE = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",  # [arXiv:2405.04434; hf]
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, vocab_size=102400,
    use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    d_ff=10944,  # dense FFN (layer 0), per hf config
    n_dense_layers=1, n_experts=64, moe_topk=6, n_shared_experts=2,
    d_ff_expert=1408, norm_type="rmsnorm", train_microbatch=2,
    # NOTE: assignment line also mentions "160 routed" — that is full V2;
    # V2-*Lite* is 64 routed + 2 shared top-6 (matches the primary spec).
)

CONFIG = DEEPSEEK_V2_LITE
