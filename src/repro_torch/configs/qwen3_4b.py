"""qwen3-4b [dense] — qk-norm + GQA, explicit head_dim=128.

36L d_model=2560 32H (kv=8) d_ff=9728 vocab=151936. [hf:Qwen/Qwen3-8B family]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936,
    qk_norm=True, rope_theta=1000000.0, tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = CONFIG.replace(
    name="qwen3-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256,
)
