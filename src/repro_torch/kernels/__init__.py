"""Hand-written CUDA kernels of the port and their launch counts."""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.build import CudaKernel


def kernels() -> Dict[str, CudaKernel]:
    """Every CUDA kernel of the port, by C entry-point name."""
    from repro_torch.kernels.adahessian import ops as ada
    from repro_torch.kernels.elastic import ops as ela
    from repro_torch.kernels.flash_attention import ops as fla

    return {k.name: k for k in (ada.KERNEL, ada.FLAT_KERNEL,
                                ela.BATCHED_KERNEL, ela.KERNEL,
                                fla.KERNEL)}


def reset_launch_counts() -> None:
    for kernel in kernels().values():
        kernel.launches = 0
