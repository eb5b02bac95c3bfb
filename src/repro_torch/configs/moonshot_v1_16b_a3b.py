"""Assigned architecture config: moonshot-v1-16b-a3b, field for field as in
``repro/configs/moonshot_v1_16b_a3b.py``."""

from repro_torch.models.config import ArchConfig

MOONSHOT_16B_A3B = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",  # [hf:moonshotai/Moonlight-16B-A3B]
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    vocab_size=163840, d_ff=11264, n_dense_layers=1,
    n_experts=64, moe_topk=6, n_shared_experts=2, d_ff_expert=1408,
    norm_type="rmsnorm", train_microbatch=2,  # GQA variant (MLA coverage comes from deepseek)
)

CONFIG = MOONSHOT_16B_A3B
