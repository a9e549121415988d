"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (kv=8) d_ff=6912 vocab=32000, SWA 4096.
[arXiv:2401.16818]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000,
    sliding_window=4096, rope_theta=10000.0,
    source="arXiv:2401.16818",
)

SMOKE = CONFIG.replace(
    name="danube-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, d_ff=256, vocab_size=256, sliding_window=32,
)
