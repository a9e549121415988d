"""PyTorch/CUDA port of the elastic-averaging trainer (``repro``).

Mirrors the JAX package's module layout. Imports ``torch`` and numpy only,
never ``jax`` and nothing of ``repro``. Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
