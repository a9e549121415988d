"""The paper's own experimental model (§VI): 2-conv-layer CNN, 28×28, 10-way."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-cnn", family="cnn",
    num_layers=2, d_model=128, num_heads=1, d_ff=128, vocab_size=10,
    source="paper §VI (PyTorch MNIST example CNN)",
)

SMOKE = CONFIG
