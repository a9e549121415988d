"""Core transformer layers: norms, RoPE (full, partial or M-RoPE), GQA
attention (causal / non-causal / sliding-window / chunked / cross, with a
KV cache), MLPs, embeddings.

Mirrors ``repro.nn.layers`` function for function, in the same layouts
(``wq (d, H, hd)``, ``wo (H, hd, d)``, activations ``(B, S, H, D)``) and
with every dtype cast where the reference puts it: norms compute in
float32 and cast back, einsums cast the parameters to the activations'
dtype, attention scores are float32 and the probabilities are cast to
``v``'s dtype. Parameters arrive as dicts of tensors.

Norms are RMSNorm or LayerNorm, MLPs SwiGLU, GeGLU or GELU (the tanh
form, as ``jax.nn.gelu``'s default), the unembedding tied or a leaf of its
own. Attention dispatches as the reference does: the flash kernel, the
blockwise attention of ``nn/flash.py`` for long full-sequence calls, or
the plain ``gqa_attention``, each with the reference's causal flag
(``causal and not cross``). The reference's ``logical_constraint`` calls
are no-ops on one device and are dropped.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import (flash_attention_bshd,
                                                     tracked)
from repro_torch.nn.flash import blockwise_attention
from repro_torch.nn.param import (ParamSpec, fan_in_init, normal_init,
                                  ones_init, zeros_init)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    p = {"scale": ParamSpec((d,), torch.float32, ones_init)}
    if cfg.norm == "layernorm":
        p["bias"] = ParamSpec((d,), torch.float32, zeros_init)
    return p


def apply_norm(params, x, cfg: ModelConfig):
    """RMSNorm or LayerNorm in float32, cast back to ``x``'s dtype."""
    if cfg.norm != "layernorm":
        return rms_norm(x, params["scale"], cfg.norm_eps)
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
    return (y * params["scale"] + params["bias"]).to(dtype)


def rms_norm(x, scale, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (y * scale).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rot_dims(cfg: ModelConfig) -> int:
    rot = int(cfg.hd * cfg.rotary_pct)
    return rot - rot % 2


def rope_angles(positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """positions (..., S), or (3, B, S) under M-RoPE → angles (..., S,
    rot/2), float32. M-RoPE gives each of the ``half`` frequencies the
    position channel (temporal, height, width) that ``mrope_sections``
    assigns it, in order."""
    half = _rot_dims(cfg) // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(half, dtype=torch.float32, device=positions.device)
        / half))
    if cfg.rope_mode == "mrope":
        secs = cfg.mrope_sections
        if sum(secs) != half:
            raise ValueError(f"{cfg.name}: mrope_sections {secs} must sum "
                             f"to the rotary half {half}")
        chan = torch.repeat_interleave(
            torch.arange(len(secs), device=positions.device),
            torch.tensor(secs, device=positions.device))
        pos = positions[chan].movedim(0, -1)  # (B, S, half)
        return pos.float() * inv_freq
    return positions[..., None].float() * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """x (B, S, H, D); angles (B, S, half)."""
    rot = _rot_dims(cfg)
    if rot == 0 or cfg.rope_mode == "none":
        return x
    half = rot // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :half], xr[..., half:]
    cos = angles.cos()[..., None, :].to(x.dtype)
    sin = angles.sin()[..., None, :].to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < x.shape[-1] else out


# ---------------------------------------------------------------------------
# Attention (GQA, causal / SWA / chunked / cross, cache-aware)
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig, cross: bool = False):
    """A cross-attention block (``cross``) has no q/k norms."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd
    p = {
        "wq": ParamSpec((d, h, hd), cfg.pdtype, fan_in_init(0)),
        "wk": ParamSpec((d, kvh, hd), cfg.pdtype, fan_in_init(0)),
        "wv": ParamSpec((d, kvh, hd), cfg.pdtype, fan_in_init(0)),
        "wo": ParamSpec((h, hd, d), cfg.pdtype, fan_in_init(1)),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = ParamSpec((hd,), torch.float32, ones_init)
        p["k_norm"] = ParamSpec((hd,), torch.float32, ones_init)
    return p


def _attn_mask(q_pos, kv_pos, cfg: ModelConfig, causal: bool):
    """q_pos (B, Sq), kv_pos (B, Skv) → bool (B, Sq, Skv)."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)
    if causal:
        mask &= kp <= qp
    if cfg.sliding_window:
        mask &= (qp - kp) < cfg.sliding_window
    if cfg.attention_chunk:
        mask &= (qp // cfg.attention_chunk) == (kp // cfg.attention_chunk)
    return mask


def _write_cache(cache, new, idx):
    """Write ``new`` (B, Sq, KVH, D) into ``cache`` (B, S, KVH, D) at
    ``idx``: an int (every row at the same offset) or a (B,) / (B, 1)
    tensor of per-row offsets (continuous batching). In place — the
    reference's ``dynamic_update_slice`` returns a new array; here the
    caller's cache tensor is the new cache."""
    new = new.to(cache.dtype)
    if isinstance(idx, torch.Tensor) and idx.ndim:
        B, Sq = new.shape[:2]
        rows = torch.arange(B, device=cache.device)[:, None]
        cols = idx.reshape(-1, 1).to(cache.device) + torch.arange(
            Sq, device=cache.device)
        cache[rows, cols] = new
    else:
        idx = int(idx)
        cache[:, idx:idx + new.shape[1]] = new
    return cache


def multihead_attention(params, x: torch.Tensor, cfg: ModelConfig, *,
                        angles: Optional[torch.Tensor] = None,
                        kv_x: Optional[torch.Tensor] = None,
                        kv_angles: Optional[torch.Tensor] = None,
                        q_pos: Optional[torch.Tensor] = None,
                        kv_pos: Optional[torch.Tensor] = None,
                        causal: bool = True, cache=None, cache_index=None,
                        kv_precomputed=None):
    """Attention of ``x`` (B, Sq, d) over itself or over a memory.

    - self-attention: ``kv_x is None`` and no ``kv_precomputed``; rope
      (``angles`` for the queries, ``kv_angles`` or else ``angles`` for the
      keys) and the q/k norms apply;
    - cross-attention: keys and values from ``kv_x`` (an encoder memory)
      or the ``kv_precomputed`` pair (B, Skv, KVH, D); no rope, no q/k
      norm, never causal;
    - with a cache ``dict(k=(B,S,KVH,D), v=...)``: the new K/V are written
      at ``cache_index`` (in place) and the queries attend over the whole
      cache. ``cache_index`` is an int, or a (B,) / (B, 1) tensor of
      per-row write positions (continuous batching); the caller passes
      per-row ``q_pos`` / rope angles to match (``DecoderLM._with_cache``
      derives both from the same index).

    Keys sit at ``kv_pos`` (default ``0..Skv-1``), queries at ``q_pos``
    (default ``0..Sq-1``); the mask is causal when ``causal`` and the call
    is not cross-attention, as in the reference.

    Dispatch as in the reference, with the tensors' device in place of
    ``use_pallas``: under the flash kernel's shape conditions
    (``Sq == Skv``, ``Sq % 128 == 0``, ``hd`` in {64, 128}, full rotary)
    the flash wrapper runs (the CUDA kernel on the card, its plain
    version on the CPU), with the window and chunk only when causal;
    otherwise a call with ``Sq >= 1024`` and both lengths multiples of
    512 runs ``blockwise_attention`` (plain PyTorch on either device);
    else the plain ``gqa_attention``. The flash kernel has no backward
    (nor has the reference's, which training never reaches:
    ``RunSpec.use_pallas`` is off by default), so a call that autograd or
    a ``torch.func`` transform tracks (the trainer's ``vmap(jvp(grad))``)
    skips the flash branch and takes the reference's training path,
    blockwise or ``gqa_attention`` by the same shape rule. Returns
    ``(out, cache)``.
    """
    B, Sq, _ = x.shape
    dt = x.dtype
    cross = kv_x is not None or kv_precomputed is not None
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    if kv_precomputed is not None:
        k, v = kv_precomputed
    else:
        src = kv_x if cross else x
        k = torch.einsum("bsd,dhk->bshk", src, params["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", src, params["wv"].to(dt))
    if cfg.qk_norm and not cross:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if not cross and cfg.rope_mode != "none":
        if angles is not None:
            q = apply_rope(q, angles, cfg)
        ka = kv_angles if kv_angles is not None else angles
        if ka is not None:
            k = apply_rope(k, ka, cfg)

    if cache is not None:
        k = _write_cache(cache["k"], k, cache_index)
        v = _write_cache(cache["v"], v, cache_index)
        cache = {"k": k, "v": v}
    Skv = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(Sq, device=x.device).expand(B, Sq)
    if kv_pos is None:
        kv_pos = torch.arange(Skv, device=x.device).expand(B, Skv)

    is_causal = causal and not cross
    window = cfg.sliding_window if is_causal else None
    chunk = cfg.attention_chunk if is_causal else None
    if (Sq == Skv and Sq % 128 == 0 and cfg.hd in (64, 128)
            and cfg.rotary_pct == 1.0 and not tracked(q, k, v)):
        out = flash_attention_bshd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=is_causal,
            window=window, chunk=chunk)
    elif Sq >= 1024 and Sq % 512 == 0 and Skv % 512 == 0:
        out = blockwise_attention(
            q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=is_causal,
            window=window, chunk=chunk)
    else:
        out = gqa_attention(q, k, v,
                            _attn_mask(q_pos, kv_pos, cfg, is_causal))
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return out, cache


def gqa_attention(q, k, v, mask):
    """q (B,Sq,H,D), k/v (B,Skv,KVH,D), mask (B,Sq,Skv) → (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    q = q.reshape(B, Sq, KVH, H // KVH, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float()
    # scaled and masked in place (the same values): nothing else holds the
    # scores, and at training shapes each copy of them, with its tangent
    # under the trainer's jvp, is the largest temporary of the layer
    scores.div_(math.sqrt(D)).masked_fill_(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wi_gate": ParamSpec((d, f), cfg.pdtype, fan_in_init(0)),
            "wi_up": ParamSpec((d, f), cfg.pdtype, fan_in_init(0)),
            "wo": ParamSpec((f, d), cfg.pdtype, fan_in_init(0)),
        }
    return {
        "wi": ParamSpec((d, f), cfg.pdtype, fan_in_init(0)),
        "wo": ParamSpec((f, d), cfg.pdtype, fan_in_init(0)),
    }


def apply_mlp(params, x, cfg: ModelConfig):
    """SwiGLU, GeGLU, or a GELU MLP (``wi`` / ``wo``). GELU is the tanh
    approximation, ``jax.nn.gelu``'s default; the exact erf form differs
    by ~1e-3."""
    dt = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, params["wi_gate"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, params["wi_up"].to(dt))
        g = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * u
    else:
        h = torch.einsum("bsd,df->bsf", x, params["wi"].to(dt))
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, params["wo"].to(dt))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_specs(cfg: ModelConfig):
    """Tied: the unembedding is the embedding's transpose; untied: a
    leaf ``unembed`` of shape (d_model, vocab)."""
    p = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                                normal_init(0.02))}
    if not cfg.tie_embeddings:
        p["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), cfg.pdtype,
                                 normal_init(0.02))
    return p


def embed(params, tokens, cfg: ModelConfig):
    return params["embedding"][tokens.long()].to(cfg.adtype)


def unembed(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x,
                            params["embedding"].to(x.dtype))
    return torch.einsum("bsd,dv->bsv", x, params["unembed"].to(x.dtype))
