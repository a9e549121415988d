"""The batched AdaHessian step: CUDA kernel on the card, plain PyTorch on the CPU.

``adahessian_update_batched`` updates the trainer's persistent (k, n)
buffers in place. A CUDA tensor launches ``csrc/adahessian.cu`` (which
replaces the Pallas ``adahessian_update_batched_flat``); a CPU tensor runs
the plain version, ``repro_torch.optim.adahessian.moment_update``, in the
same op order. There is no fallback: a CUDA tensor that cannot be
launched raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_f32
from repro_torch.optim.adahessian import moment_update as \
    adahessian_update_batched_plain

_f, _p, _ll = ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong

KERNEL = CudaKernel(
    "adahessian_update_batched", "adahessian.cu",
    [_p] * 6 + [_ll, _ll] + [_f] * 8)


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
