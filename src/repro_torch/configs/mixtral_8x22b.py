"""mixtral-8x22b [moe] — 8 experts top-2, SWA.

56L d_model=6144 48H (kv=8) d_ff=16384 vocab=32768. [arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    num_experts=8, top_k=2, expert_d_ff=16384,
    sliding_window=4096, rope_theta=1000000.0,
    source="arXiv:2401.04088",
)

SMOKE = CONFIG.replace(
    name="mixtral-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256, num_experts=4,
    expert_d_ff=64, sliding_window=32,
)
