"""Deterministic synthetic datasets.

MNIST is not available offline, so the paper reproduction uses a synthetic
28×28 10-class dataset with MNIST-like difficulty: each class is a smooth
random template; samples add template mixing, per-sample affine jitter
(shift) and pixel noise. All generation is seeded numpy — fully
reproducible. A numpy copy of ``repro.data.synthetic.SyntheticImages``: the
same seed gives the same bytes. (The token stream of the LM families is not
ported yet.)
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _smooth(rng, shape, passes=3):
    x = rng.standard_normal(shape)
    for _ in range(passes):
        x = (x + np.roll(x, 1, -1) + np.roll(x, -1, -1)
             + np.roll(x, 1, -2) + np.roll(x, -1, -2)) / 5.0
    return x


@dataclasses.dataclass
class SyntheticImages:
    """10-class 28×28 classification set (MNIST proxy)."""

    n: int = 12000
    n_test: int = 2000
    seed: int = 0
    noise: float = 0.35
    max_shift: int = 2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = _smooth(rng, (10, 28, 28)).astype(np.float32)
        self.templates /= np.abs(self.templates).max(axis=(1, 2),
                                                     keepdims=True)
        self.images, self.labels = self._gen(rng, self.n)
        self.test_images, self.test_labels = self._gen(rng, self.n_test)

    def _gen(self, rng, n):
        labels = rng.integers(0, 10, n)
        base = self.templates[labels]
        # per-sample random shift (affine jitter)
        sx = rng.integers(-self.max_shift, self.max_shift + 1, n)
        sy = rng.integers(-self.max_shift, self.max_shift + 1, n)
        imgs = np.empty((n, 28, 28), np.float32)
        for i in range(n):
            imgs[i] = np.roll(np.roll(base[i], sx[i], 0), sy[i], 1)
        imgs += self.noise * rng.standard_normal(imgs.shape).astype(
            np.float32)
        return imgs[..., None], labels.astype(np.int32)

    def test_batch(self, size=None):
        size = size or self.n_test
        return {"images": self.test_images[:size],
                "labels": self.test_labels[:size]}
