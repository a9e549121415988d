"""The port's flash-attention wrapper on the CPU (its plain version) against
the Pallas kernel it replaces, ``repro.kernels.flash_attention.ops.
flash_attention_bshd`` in interpret mode, over the sweep of
tests/test_kernels.py: MHA / GQA / MQA, S in {128, 256}, D in {64, 128},
causal, non-causal, sliding-window and chunked masks. Tolerances are the
reference's own: 2e-5 in float32, 2e-2 in bfloat16. The CUDA kernel is
held to the same plain version on the card by
tests/test_torch_kernels_cuda.py and ``chip_smoke.py``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_bshd as rflash
from repro_torch.kernels import kernels
from repro_torch.kernels.flash_attention import ops as tflash

SHAPES = [  # B, H, KVH, S, D
    (1, 2, 2, 128, 64),    # MHA
    (2, 4, 2, 256, 64),    # GQA
    (1, 8, 1, 128, 128),   # MQA, 128 lanes
    (1, 4, 2, 256, 128),   # GQA, 128 lanes, two q tiles
]
MASKS = [dict(causal=True), dict(causal=False), dict(causal=True, window=96),
         dict(causal=True, window=17), dict(causal=True, chunk=64)]
DTYPES = {"float32": (np.float32, 2e-5), "bfloat16": (ml_dtypes.bfloat16,
                                                      2e-2)}


def _qkv(seed, B, H, KVH, S, D, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype)
            for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))]


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x)


def _check(shape, mask, dtype_name, seed=0):
    dtype, tol = DTYPES[dtype_name]
    q, k, v = _qkv(seed, *shape, dtype)
    want = np.asarray(rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, **mask), np.float32)
    before = kernels()["flash_attention_fwd"].launches
    got = tflash.flash_attention_bshd(_torch(q), _torch(k), _torch(v), **mask)
    # a CPU tensor takes the plain version: no launch is counted
    assert kernels()["flash_attention_fwd"].launches == before
    assert got.dtype == _torch(q).dtype and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plain_matches_pallas_shapes(shape, dtype_name):
    _check(shape, dict(causal=True), dtype_name)


@pytest.mark.parametrize("mask", MASKS[1:], ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_plain_matches_pallas_masks(shape, mask):
    _check(shape, mask, "float32", seed=1)


@pytest.mark.parametrize("mask", [MASKS[3], MASKS[4]], ids=["window17",
                                                            "chunk64"])
def test_flash_plain_matches_pallas_masks_bf16(mask):
    _check(SHAPES[2], mask, "bfloat16", seed=2)


def test_flash_plain_window_one_attends_to_itself():
    """Causal with a window of 1: every row sees only its own key, so the
    output is ``v`` (one live key per row, probability exactly 1)."""
    q, k, v = (torch.randn(1, 128, 2, 64, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    out = tflash.flash_attention_bshd(q, k, v, causal=True, window=1)
    torch.testing.assert_close(out, v, rtol=0, atol=0)


def test_flash_wrapper_refuses_bad_inputs():
    q = torch.zeros(1, 128, 4, 64)
    kv = torch.zeros(1, 128, 2, 64)
    with pytest.raises(TypeError):
        tflash.flash_attention_bshd(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError):
        tflash.flash_attention_bshd(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError):
        tflash.flash_attention_bshd(q, torch.zeros(1, 64, 2, 64), kv)
    with pytest.raises(ValueError):
        tflash.flash_attention_bshd(q, torch.zeros(1, 128, 3, 64),
                                    torch.zeros(1, 128, 3, 64))
    with pytest.raises(ValueError):
        tflash.flash_attention_bshd(q.transpose(1, 2).contiguous()
                                    .transpose(1, 2), kv, kv)
    with pytest.raises(ValueError):
        tflash.flash_attention_bshd(q, kv, kv, window=0)
