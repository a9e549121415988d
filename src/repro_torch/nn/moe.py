"""Mixture-of-experts layer: capacity dispatch (``repro.nn.moe``).

The reference's arithmetic, step for step:

- the router is a float32 leaf, even in a bfloat16 model, and takes ``x``
  cast to float32; softmax, then the top ``K`` experts, renormalised when
  ``K > 1``;
- the Switch load-balance aux loss on the top-1 one-hot;
- every batch row is a group: its ``S*K`` routing slots, in token-major
  order, take positions inside their experts by a cumulative sum, and a
  slot past the capacity ``C`` (``_capacity``) goes to a dump row ``E``
  that is dropped, so a slot can only be displaced by earlier ones;
- the kept slots are scattered into (B, E, C, d) expert buffers, every
  expert runs all ``C`` of its slots (filled or not: the reference's
  static shapes), and the outputs are gathered back, weighted by
  ``top_p * keep``, plus the shared experts.

Ties in the top-k go to the lower expert index, as ``jax.lax.top_k``
breaks them (``torch.topk`` does not): a stable descending sort, first
``K``. The scatter is an out-of-place ``index_put``, which runs under
the trainer's ``vmap(jvp(grad))``: every kept slot has an (expert,
position) pair of its own, so a plain write gives what the reference's
accumulating scatter into zeros gives (0 + x is x), and the dump row,
written by every dropped slot in no fixed order, is sliced off. The
gather reads a buffer padded with a fresh zero row, never the dump
row. The positions come from a cumulative sum along each expert's row of
an (E, S*K) one-hot, the innermost axis. The reference's
``logical_constraint`` calls are sharding hints with no counterpart.
``moe_ref_dense`` is the dense oracle the tests hold the dispatch to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.param import ParamSpec, fan_in_init


def moe_specs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.e_dff, cfg.num_experts
    p = {
        "router": ParamSpec((d, e), torch.float32, fan_in_init(0)),
        "wi_gate": ParamSpec((e, d, f), cfg.pdtype, fan_in_init(1)),
        "wi_up": ParamSpec((e, d, f), cfg.pdtype, fan_in_init(1)),
        "wo": ParamSpec((e, f, d), cfg.pdtype, fan_in_init(1)),
    }
    if cfg.num_shared_experts:
        fs = cfg.e_dff * cfg.num_shared_experts
        p["shared"] = {
            "wi_gate": ParamSpec((d, fs), cfg.pdtype, fan_in_init(0)),
            "wi_up": ParamSpec((d, fs), cfg.pdtype, fan_in_init(0)),
            "wo": ParamSpec((fs, d), cfg.pdtype, fan_in_init(0)),
        }
    return p


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.num_experts)
    # at least top_k and 8, rounded up to a multiple of 8
    c = max(c, cfg.top_k, 8)
    return -(-c // 8) * 8


def route(params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → float32 probs (B, S, E), top_p and top_e (B, S, K):
    the top ``K`` by a stable descending sort (ties to the lower index),
    ``top_p`` renormalised when ``K > 1``."""
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :cfg.top_k], top_e[..., :cfg.top_k]
    if cfg.top_k > 1:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    return probs, top_p, top_e


def _scatter(xk, idx_e, idx_c, E: int, C: int) -> torch.Tensor:
    """Routing slots ``xk`` (B, T, d) into (B, E + 1, C, d) buffers at
    (``idx_e``, ``idx_c``); row ``E`` is the dump row of dropped slots."""
    B, T, d = xk.shape
    rows = torch.arange(B, device=xk.device)[:, None].expand(B, T)
    buf = torch.zeros(B, E + 1, C, d, dtype=xk.dtype, device=xk.device)
    return buf.index_put((rows, idx_e, idx_c), xk)


def _shared(sp, x):
    dt = x.dtype
    g = torch.einsum("bsd,df->bsf", x, sp["wi_gate"].to(dt))
    u = torch.einsum("bsd,df->bsf", x, sp["wi_up"].to(dt))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, sp["wo"].to(dt))


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → (y (B, S, d), aux float32 scalar). Each batch row
    routes within itself (groups = rows)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = _capacity(S, cfg)
    dt = x.dtype
    probs, top_p, top_e = route(params, x, cfg)

    # Switch load-balance aux: E * sum_e(frac of top-1 tokens * mean prob)
    experts = torch.arange(E, device=x.device)
    frac = (top_e[..., :1] == experts).float().mean((0, 1))
    aux = E * (frac * probs.mean((0, 1))).sum()

    # position in expert: a cumsum over each row's S*K slots, token-major
    slot_e = top_e.reshape(B, S * K)
    oh = (slot_e[:, None] == experts[:, None]).to(torch.int32)  # (B, E, T)
    pos = ((oh.cumsum(-1, dtype=torch.int32) - 1) * oh).sum(1)  # (B, T)
    keep = pos < C
    idx_e = torch.where(keep, slot_e, E)
    idx_c = torch.where(keep, pos, 0)

    xk = x[:, :, None].expand(B, S, K, d).reshape(B, S * K, d)
    expert_in = _scatter(xk, idx_e, idx_c, E, C)[:, :E]  # (B, E, C, d)

    g = torch.einsum("becd,edf->becf", expert_in, params["wi_gate"].to(dt))
    u = torch.einsum("becd,edf->becf", expert_in, params["wi_up"].to(dt))
    eo = torch.einsum("becf,efd->becd", F.silu(g) * u, params["wo"].to(dt))

    padded = torch.cat([eo, eo.new_zeros(B, 1, C, d)], dim=1)
    rows = torch.arange(B, device=x.device)[:, None]
    yk = padded[rows, idx_e, idx_c]  # (B, S*K, d)
    w = (top_p.reshape(B, S * K) * keep).to(dt)
    y = (yk * w[..., None]).reshape(B, S, K, d).sum(2)
    if cfg.num_shared_experts:
        y = y + _shared(params["shared"], x)
    return y, aux


def moe_ref_dense(params, x: torch.Tensor, cfg: ModelConfig):
    """Dense oracle: every token through every expert, weighted by its
    renormalised top-k gate (tests only; equals ``apply_moe`` when no slot
    is dropped)."""
    dt = x.dtype
    probs, top_p, top_e = route(params, x, cfg)
    gate = torch.zeros_like(probs).scatter(-1, top_e, top_p)
    g = torch.einsum("bsd,edf->bsef", x, params["wi_gate"].to(dt))
    u = torch.einsum("bsd,edf->bsef", x, params["wi_up"].to(dt))
    eo = torch.einsum("bsef,efd->bsed", F.silu(g) * u, params["wo"].to(dt))
    y = torch.einsum("bsed,bse->bsd", eo, gate.to(dt))
    if cfg.num_shared_experts:
        y = y + _shared(params["shared"], x)
    return y
