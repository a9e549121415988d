"""stablelm-3b [dense] — LayerNorm + partial rotary (25%).

32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b family config, scaled per assignment]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    norm="layernorm", rotary_pct=0.25, rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = CONFIG.replace(
    name="stablelm-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=256, vocab_size=256,
)
