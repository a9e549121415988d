"""moonshot-v1-16b-a3b [moe] — Moonlight-16B-A3B (DeepSeek-V3-like MoE).

48L d_model=2048 16H (kv=16) vocab=163840; 64 routed experts top-6 (+2
shared), expert d_ff=1408 (assignment's d_ff), first layer dense (d_ff
11264 = 8×1408 per the Moonlight card). [hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=11264, vocab_size=163840,
    num_experts=64, top_k=6, num_shared_experts=2, expert_d_ff=1408,
    first_dense_layers=1, rope_theta=50000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE = CONFIG.replace(
    name="moonshot-smoke", num_layers=3, d_model=128, num_heads=4,
    num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=256, num_experts=4,
    top_k=2, num_shared_experts=1, expert_d_ff=64, first_dense_layers=1,
)
