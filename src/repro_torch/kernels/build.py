"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/*.cu`` exposes plain C entry points (pointers, sizes, floats,
the stream) and compiles on its own, at first use, into
``build/repro_torch_kernels/<stem>-<hash>.so`` under the checkout's root
(``build/`` is git-ignored). The hash covers the source and the flags, so
an edited source rebuilds. :func:`build` starts one nvcc per missing
library, all at once. Nothing here runs at import time: the package
imports on machines without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("adahessian.cu", "elastic.cu", "flash_attention.cu")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                           "CUDA toolkit on the machine with the card")
    return nvcc


def library_path(source: str) -> Path:
    data = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(data).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, one nvcc each, all
    started together; raise with nvcc's output if any fails."""
    paths = {src: library_path(src) for src in sources}
    todo = {src: out for src, out in paths.items() if not out.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src, out in todo.items():
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            procs[src] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
        failed = []
        for src, (proc, tmp, out) in procs.items():
            log = proc.communicate()[0].decode(errors="replace")
            if proc.returncode:
                failed.append(f"nvcc {src} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


class CudaKernel:
    """One C entry point of a csrc source, bound with ctypes.

    ``launch`` calls it on PyTorch's current stream and raises if the C
    function returns a CUDA error (``cudaGetLastError()`` after the
    launch). ``launches`` counts the successful launches — the count a run
    reads to show its main path went through this kernel."""

    def __init__(self, name: str, source: str, argtypes: Sequence):
        self.name = name
        self.source = source
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.repro_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        fn = self.load()
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            msg = self._lib.repro_error_string(code).decode()
            raise RuntimeError(f"{self.name}: CUDA error {code} ({msg})")
        self.launches += 1


def check_f32(name: str, *tensors: torch.Tensor) -> torch.device:
    """Common wrapper checks: float32, contiguous, one device (cuda or
    cpu). Returns that device."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: needs float32 tensors, got {t.dtype}")
    return _check_placement(name, tensors)


def check_f32_or_bf16(name: str, *tensors: torch.Tensor) -> torch.device:
    """As :func:`check_f32`, for kernels templated on the element type:
    float32 or bfloat16, one dtype for all ``tensors``."""
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: needs float32 or bfloat16 tensors, got "
                        f"{dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
    return _check_placement(name, tensors)


def _check_placement(name, tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev
