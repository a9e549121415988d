"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, at the paper CNN's parameter count, with the reference's tolerances
(AdaHessian step rtol 2e-5, atol 2e-6; batched elastic exchange rtol 1e-5,
atol 1e-6; one-worker exchange 1e-6). Marked ``cuda``: without a card
every test skips. Imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import kernels, reset_launch_counts
from repro_torch.kernels.adahessian import ops as tada
from repro_torch.kernels.elastic import ops as tela
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
