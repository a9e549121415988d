"""Core transformer layers of the dense decoder: norms, RoPE, GQA attention
(causal / sliding-window / chunked, with a KV cache), MLPs, embeddings.

Mirrors ``repro.nn.layers`` function for function, in the same layouts
(``wq (d, H, hd)``, ``wo (H, hd, d)``, activations ``(B, S, H, D)``) and
with every dtype cast where the reference puts it: norms compute in
float32 and cast back, einsums cast the parameters to the activations'
dtype, attention scores are float32 and the probabilities are cast to
``v``'s dtype. Parameters arrive as dicts of tensors.

Left out until their slices: layernorm, the gelu / geglu MLPs and untied
unembeddings (stablelm-3b, h2o-danube-1.8b; ``DecoderLM`` refuses them),
cross-attention (``kv_x`` / ``kv_precomputed`` of the encoder-decoder and
VLM families), M-RoPE, and the blockwise attention of ``nn/flash.py`` (a
full-sequence ``Sq >= 1024`` call raises instead of running another
algorithm). The reference's ``logical_constraint`` calls are no-ops on one
device and are dropped.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.nn.param import ParamSpec, fan_in_init, normal_init, ones_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig, d: Optional[int] = None):
    return {"scale": ParamSpec((d or cfg.d_model,), torch.float32,
                               ones_init)}


def apply_norm(params, x, cfg: ModelConfig):
    """RMSNorm in float32, cast back to ``x``'s dtype."""
    return rms_norm(x, params["scale"], cfg.norm_eps)


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
    """positions (..., S) → angles (..., S, rot/2), float32."""
    half = _rot_dims(cfg) // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(half, dtype=torch.float32, device=positions.device)
        / half))
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
# Attention (GQA, causal / SWA / chunked, cache-aware)
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd
    p = {
        "wq": ParamSpec((d, h, hd), cfg.pdtype, fan_in_init(0)),
        "wk": ParamSpec((d, kvh, hd), cfg.pdtype, fan_in_init(0)),
        "wv": ParamSpec((d, kvh, hd), cfg.pdtype, fan_in_init(0)),
        "wo": ParamSpec((h, hd, d), cfg.pdtype, fan_in_init(1)),
    }
    if cfg.qk_norm:
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
                        q_pos: Optional[torch.Tensor] = None,
                        cache=None, cache_index=None):
    """Causal self-attention over ``x`` (B, Sq, d); keys sit at positions
    ``0..Skv-1`` (the reference's ``kv_pos`` default).

    - full sequence: ``cache is None``;
    - with a cache ``dict(k=(B,S,KVH,D), v=...)``: the new K/V are written
      at ``cache_index`` (in place) and the queries attend over the whole
      cache. ``cache_index`` is an int, or a (B,) / (B, 1) tensor of
      per-row write positions (continuous batching); the caller passes
      per-row ``q_pos`` / rope angles to match (``DecoderLM._with_cache``
      derives both from the same index).

    Dispatch as in the reference, with the tensors' device in place of
    ``use_pallas``: under the flash kernel's shape conditions
    (``Sq == Skv``, ``Sq % 128 == 0``, ``hd`` in {64, 128}, full rotary)
    the flash wrapper runs (the CUDA kernel on the card, its plain
    version on the CPU); otherwise ``Sq >= 1024`` would take the
    reference's blockwise path, which is not ported and raises; else the
    plain ``gqa_attention``. Returns ``(out, cache)``.
    """
    B, Sq, _ = x.shape
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if angles is not None and cfg.rope_mode != "none":
        q = apply_rope(q, angles, cfg)
        k = apply_rope(k, angles, cfg)

    if cache is not None:
        k = _write_cache(cache["k"], k, cache_index)
        v = _write_cache(cache["v"], v, cache_index)
        cache = {"k": k, "v": v}
    Skv = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(Sq, device=x.device).expand(B, Sq)
    kv_pos = torch.arange(Skv, device=x.device).expand(B, Skv)

    if (Sq == Skv and Sq % 128 == 0 and cfg.hd in (64, 128)
            and cfg.rotary_pct == 1.0):
        out = flash_attention_bshd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            window=cfg.sliding_window, chunk=cfg.attention_chunk)
    elif Sq >= 1024 and Sq % 512 == 0 and Skv % 512 == 0:
        raise NotImplementedError(
            f"attention at Sq={Sq}, Skv={Skv} takes the reference's "
            "blockwise path (nn/flash.py::blockwise_attention), which is "
            "not ported to PyTorch yet")
    else:
        out = gqa_attention(q, k, v, _attn_mask(q_pos, kv_pos, cfg, True))
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return out, cache


def gqa_attention(q, k, v, mask):
    """q (B,Sq,H,D), k/v (B,Skv,KVH,D), mask (B,Sq,Skv) → (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    q = q.reshape(B, Sq, KVH, H // KVH, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float()
    scores = scores / math.sqrt(D)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), cfg.pdtype, fan_in_init(0)),
        "wi_up": ParamSpec((d, f), cfg.pdtype, fan_in_init(0)),
        "wo": ParamSpec((f, d), cfg.pdtype, fan_in_init(0)),
    }


def apply_mlp(params, x, cfg: ModelConfig):
    """SwiGLU."""
    dt = x.dtype
    g = torch.einsum("bsd,df->bsf", x, params["wi_gate"].to(dt))
    u = torch.einsum("bsd,df->bsf", x, params["wi_up"].to(dt))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, params["wo"].to(dt))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_specs(cfg: ModelConfig):
    """Tied: the unembedding is the embedding's transpose."""
    return {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                                   normal_init(0.02))}


def embed(params, tokens, cfg: ModelConfig):
    return params["embedding"][tokens.long()].to(cfg.adtype)


def unembed(params, x, cfg: ModelConfig):
    return torch.einsum("bsd,vd->bsv", x, params["embedding"].to(x.dtype))
