"""Worker-failure model (paper §VI): a worker's communication with the master
is suppressed with probability ``failure_prob`` (1/3 in the paper) at each
communication round. The oracle baseline (EAHES-OM) reads this schedule.

The reference draws the i.i.d. schedule with ``jax.random.bernoulli`` on a
threefry key, so its bits are not numpy's. This module evaluates the same
generator in numpy — Threefry-2x32 (20 rounds) over a 64-bit element
counter split into two 32-bit words, the 32 output bits ``x0 ^ x1``, the
uniform ``bitcast((bits >> 9) | 0x3F800000) - 1.0`` and ``u < p`` in
float32 — so every seed gives the reference's schedule bit for bit
(``tests/test_torch_host.py`` holds it against ``repro.core.failure``).
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 block cipher on uint32 counter words ``(x0, x1)``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def threefry_key(seed: int):
    """The raw key of ``jax.random.key(seed)`` with 32-bit integers: the
    seed wraps to 32 bits, so the high word is 0 (``key(7)`` → ``[0, 7]``,
    ``key(2**32 + 5)`` → ``[0, 5]``)."""
    return np.uint32(0), np.uint32(int(seed) & 0xFFFFFFFF)


def uniform_f32(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32)`` (partitionable threefry:
    element i is enciphered from counter i)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


def failure_schedule_np(seed: int, rounds: int, k: int, prob: float
                        ) -> np.ndarray:
    """(rounds, k) bool — True = communication suppressed that round; the
    reference's ``failure_schedule_np`` bits for the same integer seed."""
    return uniform_f32(threefry_key(seed), (rounds, k)) < np.float32(prob)

