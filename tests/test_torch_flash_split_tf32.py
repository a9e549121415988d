"""The arithmetic of the float32 flash-attention kernel on the card
(``csrc/flash_attention.cu``, ``flash_fwd_split_tf32``: split TF32 on the tensor
cores), emulated in plain PyTorch on the CPU and held against the JAX
reference's oracle ``repro.kernels.flash_attention.ref.mha_reference`` at
the float32 tolerance, 2e-5, before any card runs it.

The emulation does what the kernel does, step for step: each operand x is
split into hi = x rounded to the nearest TF32 value (ties away from zero,
as ``cvt.rna.tf32.f32``: the low 13 mantissa bits cleared) and lo = x - hi
rounded to TF32 in turn; each product is lo*hi + hi*lo + hi*hi summed in
float32; the online softmax walks 32- or 64-row kv tiles with a float32
running max and sum, rescaling the output every tile, and P is split like
any operand. Shapes and masks are the reference's own sweep
(``tests/test_kernels.py``). One TF32 product, with no split, misses the
tolerance: that is why the kernel takes three.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import mha_reference
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-5
SHAPES = [  # B, H, KVH, S, D: tests/test_kernels.py's sweep and mask case
    (1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
    (2, 2, 2, 256, 64)]
MASKS = [dict(causal=True), dict(causal=False), dict(causal=True, window=96),
         dict(causal=True, window=17), dict(causal=True, chunk=64)]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value, ties away from zero: half of the
    13 dropped bits' range added to the magnitude, then the bits cleared
    (the sign bit is apart from the magnitude, so one add serves both
    signs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, split_terms: bool = True):
    """a @ b as the kernel's wgmma computes it: three TF32 products summed
    in float32 (or, with ``split_terms`` off, one)."""
    if not split_terms:
        return tf32_rna(a) @ tf32_rna(b)
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def flash_f32_emulated(q, k, v, *, causal=True, window=None, chunk=None,
                       kv_rows=64, split_terms=True):
    """q (B,S,H,D), k/v (B,S,KVH,D) float32 → (B,S,H,D): the kernel's
    online softmax over ``kv_rows``-row tiles, with its products."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    qh = q.permute(0, 2, 1, 3)                       # B, H, S, D
    kh = k.permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    c = 1.0 / math.sqrt(D) / math.log(2.0)           # scale, in log2 units
    qp = torch.arange(S)[:, None]
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros(B, H, S)
    o = torch.zeros(B, H, S, D)
    for k0 in range(0, S, kv_rows):
        kp = torch.arange(k0, k0 + kv_rows)[None, :]
        live = torch.ones(S, kv_rows, dtype=torch.bool)
        if causal:
            live &= kp <= qp
        if window is not None:
            live &= (qp - kp) < window
        if chunk is not None:
            live &= (qp // chunk) == (kp // chunk)
        s = product(qh, kh[:, :, k0:k0 + kv_rows].transpose(-1, -2),
                    split_terms).masked_fill(~live, -math.inf)
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - mx) * c)
        p = torch.exp2(s * c - (mx * c)[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + product(p, vh[:, :, k0:k0 + kv_rows],
                                          split_terms)
        m = mx
    o = o / torch.where(l == 0, 1.0, l)[..., None]
    return o.permute(0, 2, 1, 3)


_reference = jax.jit(mha_reference,
                     static_argnames=("causal", "window", "chunk"))


def _key(mask):
    return tuple(sorted(mask.items()))


@functools.lru_cache(maxsize=None)
def _case(shape, mask_key):
    B, H, KVH, S, D = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    want = _reference(*(jnp.moveaxis(jnp.asarray(x), 1, 2)
                        for x in (q, k, v)), **dict(mask_key))
    return q, k, v, np.moveaxis(np.asarray(want), 2, 1)


@pytest.mark.parametrize("kv_rows", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mask", MASKS)
def test_split_tf32_matches_reference(shape, mask, kv_rows):
    q, k, v, want = _case(shape, _key(mask))
    got = flash_f32_emulated(*(torch.from_numpy(x) for x in (q, k, v)),
                             kv_rows=kv_rows, **mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_one_tf32_product_misses_the_tolerance():
    """Without the split, TF32's 10 mantissa bits put the output beyond
    2e-5 of the reference at D=128: the kernel needs all three terms."""
    q, k, v, want = _case((1, 8, 1, 128, 128), _key(dict(causal=True)))
    got = flash_f32_emulated(*(torch.from_numpy(x) for x in (q, k, v)),
                             split_terms=False)
    err = np.abs(got.numpy() - want) - TOL * np.abs(want)
    assert err.max() > TOL


def test_tf32_rounding_is_nearest_ties_away():
    """The emulated ``cvt.rna.tf32.f32``: values with 10 mantissa bits are
    kept, the half-way case rounds away from zero in both signs, and hi +
    lo gives x back exactly."""
    one_ulp = 2.0 ** -10  # TF32's spacing at 1.0
    x = torch.tensor([1.0, 1.0 + one_ulp, 1.0 + one_ulp / 2,
                      -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2.0 ** -23])
    want = torch.tensor([1.0, 1.0 + one_ulp, 1.0 + one_ulp,
                         -(1.0 + one_ulp), 1.0])
    assert torch.equal(tf32_rna(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = split(r)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert torch.equal(hi + (r - hi), r)
    assert float(((r - hi) / r).abs().max()) <= 2.0 ** -11
