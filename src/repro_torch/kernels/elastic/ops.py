"""The elastic exchange: CUDA kernels on the card, plain PyTorch on the CPU.

Both wrappers update flat float32 buffers in place. A CUDA tensor launches
``csrc/elastic.cu`` (which replaces the Pallas ``elastic_update_flat`` and
``elastic_update_batched_flat``); a CPU tensor runs the plain versions in
``repro_torch.core.elastic``, in the same op order. There is no fallback:
a CUDA tensor that cannot be launched raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.elastic import elastic_update as elastic_update_plain
from repro_torch.core.elastic import \
    elastic_update_batched as elastic_update_batched_plain
from repro_torch.kernels.build import CudaKernel, check_f32

_p, _ll = ctypes.c_void_p, ctypes.c_longlong

BATCHED_KERNEL = CudaKernel("elastic_update_batched", "elastic.cu",
                            [_p] * 4 + [_ll, _ll])
KERNEL = CudaKernel("elastic_update", "elastic.cu", [_p] * 3 + [_ll])


def elastic_update(worker: torch.Tensor, master: torch.Tensor,
                   h: torch.Tensor) -> None:
    """One worker's exchange, in place: ``worker``/``master`` (n,), ``h``
    the (2, 1) ``[h1; h2]`` on their device."""
    dev = check_f32("elastic_update", worker, master, h)
    if worker.ndim != 1 or master.shape != worker.shape or h.shape != (2, 1):
        raise ValueError(
            f"elastic_update: worker {tuple(worker.shape)}, master "
            f"{tuple(master.shape)}, h {tuple(h.shape)}; need (n,), (n,), "
            "(2, 1)")
    if dev.type == "cpu":
        elastic_update_plain(worker, master, h)
        return
    KERNEL.launch(worker.data_ptr(), master.data_ptr(), h.data_ptr(),
                  worker.shape[0])


def elastic_update_batched(workers: torch.Tensor, master: torch.Tensor,
                           h: torch.Tensor,
                           master_ref: Optional[torch.Tensor] = None) -> None:
    """All k exchanges plus the master reduction, in place: ``workers``
    (k, n), ``master`` (n,), ``h`` (2, k); ``master_ref`` (n,) is the
    stale snapshot of delayed averaging, or None."""
    extra = () if master_ref is None else (master_ref,)
    dev = check_f32("elastic_update_batched", workers, master, h, *extra)
    if workers.ndim != 2:
        raise ValueError("elastic_update_batched: workers must be (k, n)")
    k, n = workers.shape
    if master.shape != (n,) or h.shape != (2, k) or any(
            r.shape != (n,) for r in extra):
        raise ValueError(
            f"elastic_update_batched: workers {(k, n)}, master "
            f"{tuple(master.shape)}, h {tuple(h.shape)}; need (n,), (2, k)")
    if dev.type == "cpu":
        elastic_update_batched_plain(workers, master, h, master_ref)
        return
    BATCHED_KERNEL.launch(
        workers.data_ptr(), master.data_ptr(),
        None if master_ref is None else master_ref.data_ptr(), h.data_ptr(),
        k, n)
