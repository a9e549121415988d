"""qwen2-vl-7b [vlm] — M-RoPE + dynamic resolution; vision frontend STUBBED.

28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064, head_dim=128,
mrope_sections=(16,24,24). [arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    rope_mode="mrope", mrope_sections=(16, 24, 24), rope_theta=1000000.0,
    num_patch_tokens=1024, frontend="vision",
    source="arXiv:2409.12191",
)

SMOKE = CONFIG.replace(
    name="qwen2-vl-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256,
    mrope_sections=(6, 5, 5), num_patch_tokens=16,
)
