"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert.

48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048; chunked causal attention
(8192) for long context (iRoPE-style). [hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=16, top_k=1, num_shared_experts=1, expert_d_ff=8192,
    attention_chunk=8192, rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = CONFIG.replace(
    name="llama4-scout-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256, num_experts=4,
    expert_d_ff=64, attention_chunk=32,
)
