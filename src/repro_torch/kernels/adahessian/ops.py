"""The AdaHessian steps: CUDA kernels on the card, plain PyTorch on the CPU.

- ``adahessian_update_batched`` updates the elastic trainer's persistent
  (k, n) buffers in place (replaces the Pallas
  ``adahessian_update_batched_flat``; plain version
  ``repro_torch.optim.adahessian.moment_update``).
- ``adahessian_step`` is one worker's step on flat (n,) buffers, the k=1
  plain control's update (replaces the Pallas ``adahessian_update_flat``
  behind ``repro.kernels.adahessian.ops.adahessian_step_pallas``; plain
  version :func:`adahessian_step_plain`). Its seven scalars arrive in a
  (7,) tensor on the buffers' device, built by :func:`pack_scalars`.

Both kernels live in ``csrc/adahessian.cu``. A CUDA tensor launches the
kernel, a CPU tensor runs the plain version in the same op order. There is
no fallback: a CUDA tensor that cannot be launched raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.kernels.build import CudaKernel, check_f32
from repro_torch.optim.adahessian import moment_update as \
    adahessian_update_batched_plain

_f, _p, _ll = ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong

KERNEL = CudaKernel(
    "adahessian_update_batched", "adahessian.cu",
    [_p] * 6 + [_ll, _ll] + [_f] * 8)
FLAT_KERNEL = CudaKernel("adahessian_update_flat", "adahessian.cu",
                         [_p] * 6 + [_ll])


def adahessian_update_batched(p, g, h, m, v, bc, *, lr: float, b1: float,
                              b2: float, denom_pow: float, eps: float,
                              lrwd: float = 0.0) -> None:
    """One AdaHessian step for all k workers, in place on ``p, m, v``.

    ``p, g, h, m, v`` are (k, n) float32 (``h`` already spatially
    averaged); ``bc`` is the (2, k) per-worker ``[1 − β1^t; 1 − β2^t]``."""
    dev = check_f32("adahessian_update_batched", p, g, h, m, v, bc)
    if p.ndim != 2 or any(x.shape != p.shape for x in (g, h, m, v)):
        raise ValueError("adahessian_update_batched: p, g, h, m, v must "
                         f"share one (k, n) shape, got {p.shape}")
    k, n = p.shape
    if bc.shape != (2, k):
        raise ValueError(f"adahessian_update_batched: bc {tuple(bc.shape)} "
                         f"!= (2, {k})")
    if dev.type == "cpu":
        adahessian_update_batched_plain(p, g, h, m, v, bc, lr=lr, b1=b1,
                                        b2=b2, denom_pow=denom_pow, eps=eps,
                                        lrwd=lrwd)
        return
    if k > 65535:
        raise ValueError(f"adahessian_update_batched: k={k} > 65535 workers")
    KERNEL.launch(p.data_ptr(), g.data_ptr(), h.data_ptr(), m.data_ptr(),
                  v.data_ptr(), bc.data_ptr(), k, n, lr, b1, 1 - b1, b2,
                  1 - b2, denom_pow, eps, lrwd)


def pack_scalars(cfg: OptimizerConfig, t: torch.Tensor) -> torch.Tensor:
    """The (7,) float32 ``[lr, β1, β2, 1 − β1^t, 1 − β2^t, κ/2, ε]`` of
    :func:`adahessian_step` for the step count ``t`` (a 0-d tensor on the
    buffers' device, already incremented), built on ``t``'s device so no
    scalar travels from the host per step (the reference's
    ``repro.kernels.adahessian.ops.pack_scalars``)."""
    b1, b2 = cfg.betas
    tf = t.to(torch.float32).reshape(())
    full = lambda x: torch.full_like(tf, x)
    return torch.stack([full(cfg.lr), full(b1), full(b2),
                        1.0 - full(b1).pow(tf), 1.0 - full(b2).pow(tf),
                        full(cfg.hessian_power / 2.0), full(cfg.eps)])


def adahessian_step_plain(p, g, h, m, v, scalars) -> None:
    """Plain version of ``adahessian_update_flat``, in place on ``p, m, v``,
    in the Pallas kernel's op order (``_kernel`` in
    ``repro/kernels/adahessian/kernel.py``)::

        m ← β1·m + (1−β1)·g
        v ← β2·v + (1−β2)·h·h
        p ← p − lr·(m/bc1) / (exp(κ/2 · log(v/bc2 + 1e-30)) + ε)
    """
    lr, b1, b2, bc1, bc2, half_k, eps = scalars.unbind()
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * h * h)
    denom = torch.exp(half_k * torch.log(v / bc2 + 1e-30)) + eps
    p.sub_(lr * (m / bc1) / denom)


def adahessian_step(p, g, h, m, v, scalars) -> None:
    """One worker's AdaHessian step, in place on ``p, m, v``: all (n,)
    float32 (``h`` already spatially averaged), ``scalars`` the (7,) of
    :func:`pack_scalars`. No weight decay (the batched kernel at k=1
    carries the ``lr·wd`` term)."""
    dev = check_f32("adahessian_step", p, g, h, m, v, scalars)
    if p.ndim != 1 or any(x.shape != p.shape for x in (g, h, m, v)):
        raise ValueError("adahessian_step: p, g, h, m, v must share one "
                         f"(n,) shape, got {tuple(p.shape)}")
    if scalars.shape != (7,):
        raise ValueError(f"adahessian_step: scalars {tuple(scalars.shape)} "
                         "!= (7,)")
    if dev.type == "cpu":
        adahessian_step_plain(p, g, h, m, v, scalars)
        return
    FLAT_KERNEL.launch(p.data_ptr(), g.data_ptr(), h.data_ptr(), m.data_ptr(),
                       v.data_ptr(), scalars.data_ptr(), p.shape[0])
