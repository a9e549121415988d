"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, with the reference's tolerances: the elastic-training kernels at the
paper CNN's parameter count (AdaHessian step rtol 2e-5, atol 2e-6; batched
elastic exchange rtol 1e-5, atol 1e-6; one-worker exchange 1e-6), flash
attention over the CPU tests' sweep plus qwen3-4b's prefill shape (2e-5
in float32, 2e-2 in bfloat16). Marked ``cuda``: without a card
every test skips. Imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import kernels, reset_launch_counts
from repro_torch.kernels.adahessian import ops as tada
from repro_torch.kernels.elastic import ops as tela
from repro_torch.kernels.flash_attention import ops as tfla
from repro_torch.optim.adahessian import bias_corrections


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda")


N_CARD = 1_199_882  # the paper CNN's parameter count


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("power", [1.0, 0.5])
def test_adahessian_kernel_matches_plain(cuda, k, power):
    gen = torch.Generator(cuda).manual_seed(k)
    r = lambda s=1.0: s * torch.randn(k, N_CARD, generator=gen, device=cuda)
    p, g, h, m = r(), r(), r(), r(0.1)
    v = r(0.1).abs()
    bc = bias_corrections(torch.arange(1, k + 1, device=cuda) * 2 + 1,
                          (0.9, 0.999))
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, denom_pow=power / 2, eps=1e-8,
              lrwd=1e-7)
    outs = [x.clone() for x in (p, m, v)]
    reset_launch_counts()
    tada.adahessian_update_batched(outs[0], g, h, outs[1], outs[2], bc, **kw)
    torch.cuda.synchronize()
    assert kernels()["adahessian_update_batched"].launches == 1
    tada.adahessian_update_batched_plain(p, g, h, m, v, bc, **kw)
    for got, want in zip(outs, (p, m, v)):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("stale", [False, True])
def test_elastic_batched_kernel_matches_plain(cuda, k, stale):
    gen = torch.Generator(cuda).manual_seed(k)
    w = torch.randn(k, N_CARD, generator=gen, device=cuda)
    m, ref = (torch.randn(N_CARD, generator=gen, device=cuda)
              for _ in range(2))
    h = torch.rand(2, k, generator=gen, device=cuda) * 0.5
    w2, m2 = w.clone(), m.clone()
    reset_launch_counts()
    tela.elastic_update_batched(w2, m2, h, ref if stale else None)
    torch.cuda.synchronize()
    assert kernels()["elastic_update_batched"].launches == 1
    tela.elastic_update_batched_plain(w, m, h, ref if stale else None)
    torch.testing.assert_close(w2, w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m2, m, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_elastic_one_worker_kernel_matches_plain(cuda):
    gen = torch.Generator(cuda).manual_seed(0)
    w, m = (torch.randn(N_CARD, generator=gen, device=cuda) for _ in range(2))
    h = torch.tensor([[0.25], [0.07]], device=cuda)
    w2, m2 = w.clone(), m.clone()
    reset_launch_counts()
    tela.elastic_update(w2, m2, h)
    torch.cuda.synchronize()
    assert kernels()["elastic_update"].launches == 1
    tela.elastic_update_plain(w, m, h)
    torch.testing.assert_close(w2, w, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m2, m, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,KVH,S,D", [
    (1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
    (1, 32, 8, 512, 128)])  # the last: qwen3-4b's prefill at 512 tokens
@pytest.mark.parametrize("mask", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=17),
    dict(causal=True, window=96), dict(causal=True, chunk=64)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, B, H, KVH, S, D, mask):
    """Flash attention, kernel against plain version, at the reference's
    tolerances (2e-5 in float32, 2e-2 in bfloat16)."""
    gen = torch.Generator(cuda).manual_seed(S + D)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, KVH, D, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    reset_launch_counts()
    got = tfla.flash_attention_bshd(q, k, v, **mask)
    torch.cuda.synchronize()
    assert kernels()["flash_attention_fwd"].launches == 1
    want = tfla.flash_attention_plain(q, k, v, **mask)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
