"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, with the reference's tolerances: the elastic-training kernels at the
paper CNN's parameter count (AdaHessian steps, batched and single-worker,
rtol 2e-5, atol 2e-6; batched
elastic exchange rtol 1e-5, atol 1e-6; one-worker exchange 1e-6), flash
attention over the CPU tests' sweep plus qwen3-4b's prefill shape and the
LM evals' shapes (2e-5 in float32, 2e-2 in bfloat16; each dtype's
tensor-core kernel, bf16 and split TF32, swept over D, S, GQA ratio and
every mask), and the blockwise attention of
``nn/flash.py`` (plain PyTorch) against its naive oracle on the card
(3e-5 in float32, 2e-2 in bfloat16). Marked ``cuda``: without a card
every test skips. Imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.configs.base import OptimizerConfig
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
@pytest.mark.parametrize("n", [N_CARD, 1001])
@pytest.mark.parametrize("t,power", [(1, 1.0), (3, 1.0), (3, 0.5)])
def test_adahessian_flat_kernel_matches_plain(cuda, n, t, power):
    """The single-worker step of the plain control, at the paper CNN's n
    and an odd n, against its plain version."""
    gen = torch.Generator(cuda).manual_seed(n + t)
    r = lambda s=1.0: s * torch.randn(n, generator=gen, device=cuda)
    p, g, h, m = r(), r(), r(), r(0.1)
    v = r(0.1).abs()
    cfg = OptimizerConfig(lr=1e-3, hessian_power=power)
    scalars = tada.pack_scalars(cfg, torch.tensor(t, device=cuda))
    outs = [x.clone() for x in (p, m, v)]
    reset_launch_counts()
    tada.adahessian_step(outs[0], g, h, outs[1], outs[2], scalars)
    torch.cuda.synchronize()
    assert kernels()["adahessian_update_flat"].launches == 1
    tada.adahessian_step_plain(p, g, h, m, v, scalars)
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
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("stale", [False, True])
def test_elastic_batched_kernel_matches_plain_odd_n(cuda, k, stale):
    """At an odd n every worker row but the first starts only 4-byte
    aligned: the kernel takes its scalar path and masks nothing wrong."""
    n = 999_983
    gen = torch.Generator(cuda).manual_seed(k + 10)
    w = torch.randn(k, n, generator=gen, device=cuda)
    m, ref = (torch.randn(n, generator=gen, device=cuda) for _ in range(2))
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
@pytest.mark.parametrize("cap,groups", [(16, 4), (7, 3), (8, 2)])
def test_elastic_grouped_kernel_route_matches_plain(cuda, cap, groups):
    """The hierarchy's rack exchange: one batched launch per rack on the
    rack's row block (rows of an odd rack start only 8-byte aligned),
    against the plain grouped update; a dead slot's row stays
    bit-unchanged."""
    from repro_torch.core.dynamic_weight import group_assignment

    grp = group_assignment(cap, groups)
    gen = torch.Generator(cuda).manual_seed(cap)
    w = torch.randn(cap, N_CARD, generator=gen, device=cuda)
    sm = torch.randn(groups, N_CARD, generator=gen, device=cuda)
    h = torch.rand(2, cap, generator=gen, device=cuda) * 0.5
    h[:, 1] = 0.0
    w2, sm2 = w.clone(), sm.clone()
    reset_launch_counts()
    tela.elastic_update_grouped(w2, sm2, h, grp)
    torch.cuda.synchronize()
    assert kernels()["elastic_update_batched"].launches == groups
    tela.elastic_update_grouped_plain(w, sm, h, grp)
    torch.testing.assert_close(w2, w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sm2, sm, rtol=1e-5, atol=1e-6)
    assert torch.equal(w2[1], w[1])


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
    (1, 32, 8, 512, 128),   # qwen3-4b's prefill at 512 tokens
    (2, 32, 8, 128, 128),   # the LM eval of chip_smoke.py's 8a
    (16, 12, 3, 512, 64),   # the LM eval of train_lm_elastic's 100m preset
    (1, 16, 16, 512, 128)])  # moonshot-v1-16b-a3b's admit at 512 tokens
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


FLASH_MASKS = [dict(causal=True), dict(causal=False),
               dict(causal=True, window=17), dict(causal=True, window=96),
               dict(causal=True, chunk=64)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 256, 512])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("mask", FLASH_MASKS)
def test_flash_bf16_tensor_core_sweep(cuda, D, S, group, mask):
    """The bfloat16 (tensor-core) kernel over head dims, lengths, GQA
    ratios H/KVH and every mask, against the plain version at 2e-2."""
    B, KVH = 2, 2
    H = KVH * group
    gen = torch.Generator(cuda).manual_seed(D + S + group)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, KVH, D, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    reset_launch_counts()
    got = tfla.flash_attention_bshd(q, k, v, **mask)
    torch.cuda.synchronize()
    assert kernels()["flash_attention_fwd"].launches == 1
    want = tfla.flash_attention_plain(q, k, v, **mask)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 256, 512, 1024])
@pytest.mark.parametrize("H,KVH", [(2, 2), (4, 2), (8, 2), (9, 3)])
@pytest.mark.parametrize("mask", FLASH_MASKS)
def test_flash_f32_split_tf32_sweep(cuda, D, S, H, KVH, mask):
    """The float32 (split-TF32 tensor-core) kernel over head dims, lengths,
    GQA ratios H/KVH 1, 2, 4 and 3 (with KVH=3, as the 100m preset has) and
    every mask, against the plain version at 2e-5."""
    gen = torch.Generator(cuda).manual_seed(D + S + H)
    q = torch.randn(2, S, H, D, generator=gen, device=cuda)
    k, v = (torch.randn(2, S, KVH, D, generator=gen, device=cuda)
            for _ in range(2))
    reset_launch_counts()
    got = tfla.flash_attention_bshd(q, k, v, **mask)
    torch.cuda.synchronize()
    assert kernels()["flash_attention_fwd"].launches == 1
    want = tfla.flash_attention_plain(q, k, v, **mask)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mask", [dict(causal=True, window=700),
                                  dict(causal=True, chunk=512)])
def test_blockwise_attention_on_the_card(cuda, dtype, tol, mask):
    """The blockwise attention of ``nn/flash.py`` (plain PyTorch, run on
    the card: head_dim 80 takes it, not the flash kernel) against the
    naive oracle on the card, at danube's head shape over 2048 tokens;
    3e-5 in float32 (``tests/test_flash_blockwise.py``), 2e-2 in
    bfloat16. No kernel launches."""
    from repro_torch.nn.flash import blockwise_attention, naive_attention

    B, S, H, KVH, D = 1, 2048, 32, 8, 80
    gen = torch.Generator(cuda).manual_seed(S + D)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, KVH, D, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    pos = torch.arange(S, device=cuda).expand(B, S)
    reset_launch_counts()
    got = blockwise_attention(q, k, v, q_pos=pos, kv_pos=pos, **mask)
    assert not any(x.launches for x in kernels().values())
    want = naive_attention(q, k, v, q_pos=pos, kv_pos=pos, **mask)
    assert got.dtype == dtype and got.device.type == "cuda"
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_kernel_refuses_gradients(cuda):
    """The kernel has no backward: on CUDA tensors that autograd or a
    ``torch.func`` transform tracks, the wrapper raises instead of
    returning an output with no graph, and launches nothing; under
    ``no_grad`` the same inputs run the kernel."""
    gen = torch.Generator(cuda).manual_seed(0)
    q = torch.randn(1, 128, 4, 64, generator=gen, device=cuda)
    kv = torch.randn(1, 128, 2, 64, generator=gen, device=cuda)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        tfla.flash_attention_bshd(q.clone().requires_grad_(), kv, kv)
    with pytest.raises(RuntimeError, match="no backward"):
        torch.func.grad(lambda x: tfla.flash_attention_bshd(x, kv, kv)
                        .sum())(q)
    assert kernels()["flash_attention_fwd"].launches == 0
    with torch.no_grad():
        out = tfla.flash_attention_bshd(q.clone().requires_grad_(), kv, kv)
    torch.cuda.synchronize()
    assert kernels()["flash_attention_fwd"].launches == 1
    torch.testing.assert_close(out, tfla.flash_attention_plain(q, kv, kv),
                               rtol=2e-5, atol=2e-5)
