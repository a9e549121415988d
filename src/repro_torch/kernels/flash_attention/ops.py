"""Flash attention forward: a CUDA kernel on the card, plain PyTorch on
the CPU.

:func:`flash_attention_bshd` takes the layers' BSHD layout, as
``repro.kernels.flash_attention.ops.flash_attention_bshd`` does. A CUDA
tensor launches ``csrc/flash_attention.cu`` (which replaces the Pallas
``flash_attention`` of ``repro/kernels/flash_attention/kernel.py``); a CPU
tensor runs :func:`flash_attention_plain`, the full-matrix masked softmax
in float32 that ``ref.py::mha_reference`` computes, cast back to the
input dtype. There is no fallback: a CUDA tensor that cannot be launched
raises.

Positions are the row indices (the kernel serves full-sequence calls:
``Sq == Skv``); K/V heads are shared GQA-style, q head ``h`` reading kv
head ``h // (H // KVH)``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel, check_f32_or_bf16

_p, _i = ctypes.c_void_p, ctypes.c_int

# q, k, v, out, B, S, H, KVH, D, is_bf16, causal, window, chunk
KERNEL = CudaKernel("flash_attention_fwd", "flash_attention.cu",
                    [_p] * 4 + [_i] * 9)
BLOCK = 64  # the kernel's q and kv tile: S must be a multiple on the card


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,KVH,D) → (B,S,H,D) in q's dtype: masked
    softmax over the full (S, S) score matrix in float32; a row with no
    live key gives zeros."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    qg = q.float().reshape(B, S, KVH, H // KVH, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    live = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        live &= kp <= qp
    if window is not None:
        live &= (qp - kp) < window
    if chunk is not None:
        live &= (qp // chunk) == (kp // chunk)
    p = torch.softmax(s.masked_fill(~live, -1e30), dim=-1)
    p = p * live.any(-1)[:, None]
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def flash_attention_bshd(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,KVH,D), float32 or bfloat16, contiguous, on
    one device → (B,S,H,D). ``window``/``chunk``: None or a positive int.
    On the card D must be 64 or 128 and S a multiple of 64."""
    dev = check_f32_or_bf16("flash_attention", q, k, v)
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; need "
                         "(B,S,H,D) and two equal (B,S,KVH,D)")
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if k.shape != (B, S, KVH, D) or H % KVH:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} need the same B, S, D and H a "
                         "multiple of KVH")
    for name, val in (("window", window), ("chunk", chunk)):
        if val is not None and val < 1:
            raise ValueError(f"flash_attention: {name}={val} must be >= 1")
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk)
    if D not in (64, 128) or S % BLOCK:
        raise ValueError(f"flash_attention: the kernel takes D in (64, 128) "
                         f"and S % {BLOCK} == 0, got D={D}, S={S}")
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: the kernel reads 16-byte "
                         "vectors; tensors must start 16-byte aligned")
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, S, H, KVH, D, int(q.dtype == torch.bfloat16),
                  int(causal), window or 0, chunk or 0)
    return out
