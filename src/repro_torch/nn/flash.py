"""Blockwise (FlashAttention-style) attention in plain PyTorch.

The port of ``repro.nn.flash``: online-softmax attention over query and
key/value blocks (512 by default), so live memory is O(block²) instead of
O(S²). The dense decoder takes it for a full-sequence call of
``Sq >= 1024`` whose shapes the flash kernel does not take (head_dim 80
of stablelm-3b and h2o-danube-1.8b, a partial rotary); it is plain
PyTorch, as the reference's is plain JAX.

Block pairs with no visible (query, key) pair are skipped, by the
reference's rule on each block's least and greatest position. The
reference decides that per pair on the device (``lax.cond``); here it is
decided on the host once per call (:func:`live_blocks`, one
device-to-host copy of the blocks' position bounds), so a long prefill
does not wait on the device once per block pair. :func:`kv_step` is one
online-softmax update of a query block by a key/value block.

The reference wraps each query block in ``jax.checkpoint``; inference
has nothing to rematerialise, and every op here is differentiable, so a
training caller can take gradients through it as it is.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

NEG_INF = -1e30


def _pair_mask(qp, kp, causal, window, chunk):
    """qp (..., bq, 1), kp (..., 1, bk) → bool mask."""
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=qp.device)
    if causal:
        m &= kp <= qp
    if window:
        m &= (qp - kp) < window
    if chunk:
        m &= (qp // chunk) == (kp // chunk)
    return m


def live_blocks(q_pos, kv_pos, block_q: int, block_k: int, *, causal: bool,
                window: Optional[int], chunk: Optional[int]
                ) -> List[List[int]]:
    """For each query block, the key/value blocks that can hold a visible
    pair: the reference's block-skip rule on the least and greatest
    position of each block (over the batch too)."""
    B, Sq = q_pos.shape
    nq, nk = Sq // block_q, kv_pos.shape[1] // block_k
    qb = q_pos.reshape(B, nq, block_q)
    kb = kv_pos.reshape(B, nk, block_k)
    bounds = torch.cat([qb.amin((0, 2)), qb.amax((0, 2)), kb.amin((0, 2)),
                        kb.amax((0, 2))]).tolist()
    q_lo, q_hi = bounds[:nq], bounds[nq:2 * nq]
    k_lo, k_hi = bounds[2 * nq:2 * nq + nk], bounds[2 * nq + nk:]
    live = []
    for i in range(nq):
        row = []
        for j in range(nk):
            ok = True
            if causal:
                ok &= k_lo[j] <= q_hi[i]
            if window:
                ok &= (q_lo[i] - k_hi[j]) < window
            if chunk:
                ok &= (q_hi[i] // chunk) >= (k_lo[j] // chunk)
                ok &= (q_lo[i] // chunk) <= (k_hi[j] // chunk)
            if ok:
                row.append(j)
        live.append(row)
    return live


def kv_step(m, l, acc, qi, ki, vi, qpi, kpi, *, scale, causal, window,
            chunk):
    """One online-softmax update of a query block's carries ``m``, ``l``
    (B, KVH, G, bq) and ``acc`` (B, KVH, G, bq, D), all float32, by one
    key/value block. ``qi`` (B, bq, KVH, G, D) and ``ki`` (B, bk, KVH, D)
    are float32 (the reference's float32 accumulation of the scores),
    ``vi`` in the values' dtype; ``qpi`` (B, bq), ``kpi`` (B, bk)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qi, ki) * scale
    pm = _pair_mask(qpi[:, None, None, :, None], kpi[:, None, None, None, :],
                    causal, window, chunk)
    s = torch.where(pm, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p.to(vi.dtype), vi).float()
    return m_new, l_new, acc_new


def blockwise_attention(q, k, v, *, q_pos, kv_pos, causal: bool = True,
                        window: Optional[int] = None,
                        chunk: Optional[int] = None, block_q: int = 512,
                        block_k: int = 512):
    """q (B,Sq,H,D); k, v (B,Skv,KVH,D); *_pos (B,S) → (B,Sq,H,D). A
    query row with no visible key gives zeros."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    block_q = min(block_q, Sq)
    block_k = min(block_k, Skv)
    if Sq % block_q or Skv % block_k:
        raise ValueError(f"blockwise attention needs Sq={Sq} and Skv={Skv} "
                         f"divisible by the blocks ({block_q}, {block_k})")
    scale = 1.0 / math.sqrt(D)
    live = live_blocks(q_pos, kv_pos, block_q, block_k, causal=causal,
                       window=window, chunk=chunk)
    qf = q.float().reshape(B, Sq, KVH, G, D)
    kf = k.float()
    outs = []
    for i, row in enumerate(live):
        rows = slice(i * block_q, (i + 1) * block_q)
        m = torch.full((B, KVH, G, block_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KVH, G, block_q, D), dtype=torch.float32,
                          device=q.device)
        for j in row:
            cols = slice(j * block_k, (j + 1) * block_k)
            m, l, acc = kv_step(m, l, acc, qf[:, rows], kf[:, cols],
                                v[:, cols], q_pos[:, rows], kv_pos[:, cols],
                                scale=scale, causal=causal, window=window,
                                chunk=chunk)
        l = torch.where(l == 0.0, 1.0, l)
        out = (acc / l[..., None]).to(q.dtype)  # (B, KVH, G, bq, D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, block_q, H, D))
    return torch.cat(outs, dim=1)


def naive_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=None,
                    chunk=None):
    """O(S²)-memory oracle for tests; a row with no visible key gives
    zeros (as the blockwise ``l == 0`` guard does)."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    s = s / math.sqrt(D)
    pm = _pair_mask(q_pos[:, None, None, :, None],
                    kv_pos[:, None, None, None, :], causal, window, chunk)
    s = torch.where(pm, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(pm.any(-1)[..., None], p, 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, D)
