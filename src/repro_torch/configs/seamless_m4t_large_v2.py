"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone.

24L(enc)+24L(dec) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. The audio
frontend (mel + conv feature extractor) is a STUB: the batch carries
precomputed frame embeddings. [arXiv:2308.11596]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=48, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    enc_layers=24, dec_layers=24, enc_seq_ratio=8,
    act="geglu", frontend="audio",
    source="arXiv:2308.11596",
)

SMOKE = CONFIG.replace(
    name="seamless-smoke", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=256, vocab_size=256, enc_layers=2, dec_layers=2,
)
