"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (the default of every entry point) raises when torch sees no
    card: a run never carries on on the CPU unasked; ``device="cpu"`` runs
    the kernels' plain PyTorch versions. Also turns TF32 off for matmuls
    and cuDNN, process-wide: the reference computes in full float32, and so
    does the port.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch sees no CUDA device; pass "
            "device='cpu' to run the plain PyTorch path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
