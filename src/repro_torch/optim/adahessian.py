"""AdaHessian (Yao et al., AAAI 2021) — the paper's worker-local optimizer.

Three components (paper §IV-B):
1. Hutchinson diagonal-Hessian estimate (:mod:`repro_torch.optim.hutchinson`),
   passed to ``step`` as ``hess``.
2. Spatial averaging of the diagonal over blocks of ``spatial_block``
   along the last axis (:func:`spatial_average`, done by the trainer per
   leaf before packing).
3. Adam-style moments with the gradient second moment replaced by the
   averaged Hessian diagonal, raised to ``hessian_power``.

The step for all k workers is one CUDA kernel on the card
(``repro_torch.kernels.adahessian``); :func:`moment_update` is its plain
PyTorch version, in the reference's op order
(``repro.optim.adahessian.moment_update``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.base import Optimizer


def spatial_average(h: torch.Tensor, block: int, batch_dims: int = 0
                    ) -> torch.Tensor:
    """Average |h| within blocks along the last axis (AdaHessian eq. 9), as
    ``repro.optim.adahessian.spatial_average`` does.

    For tensors whose last dim is smaller than ``block`` (biases, conv1's
    32 output channels) the whole axis is one block — so a conv kernel is
    averaged across its *output channels*, not its spatial taps.
    ``batch_dims`` leading axes (the trainer's worker axis) are kept
    apart; a tensor with no axis beyond them is returned as |h|.
    """
    h = h.float().abs()
    if h.ndim == batch_dims:
        return h
    d = h.shape[-1]
    b = min(block, d)
    if d % b != 0:
        b = 1
        for cand in range(min(block, d), 0, -1):
            if d % cand == 0:
                b = cand
                break
    hb = h.reshape(*h.shape[:-1], d // b, b)
    return hb.mean(dim=-1, keepdim=True).expand(hb.shape).reshape(h.shape)


def bias_corrections(count: torch.Tensor, betas) -> torch.Tensor:
    """(2, k) float32 ``[1 − β1^t; 1 − β2^t]`` for per-worker step counts
    ``t`` (straggler-frozen workers drift apart), on count's device."""
    t = count.float()
    return torch.stack([1 - torch.full_like(t, b).pow(t) for b in betas])


def moment_update(p, g, h, m, v, bc, *, lr: float, b1: float, b2: float,
                  denom_pow: float, eps: float, lrwd: float = 0.0) -> None:
    """Plain version of the batched AdaHessian kernel, in place on p, m, v.

    ``p, g, h, m, v`` are (k, n) float32; ``bc`` is (2, k). Per element,
    in the reference's op order:

        m ← β1·m + (1−β1)·g
        v ← β2·v + (1−β2)·h²
        u = −lr·(m/bc1) / ((v/bc2 + 1e-30)^{κ/2} + ε)  [− lr·wd·p]
        p ← p + u
    """
    bc1, bc2 = bc[0][:, None], bc[1][:, None]
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(torch.square(h) * (1 - b2))
    denom = torch.pow(v / bc2 + 1e-30, denom_pow) + eps
    u = (m / bc1) * -lr / denom
    if lrwd:
        u = u - lrwd * p
    p.add_(u)


def adahessian(cfg: OptimizerConfig) -> Optimizer:
    def init(k, n, device):
        z = lambda: torch.zeros(k, n, dtype=torch.float32, device=device)
        return {"count": torch.zeros(k, dtype=torch.int32, device=device),
                "m": z(), "v": z()}

    def step(params, grads, state, hess=None):
        from repro_torch.kernels.adahessian.ops import \
            adahessian_update_batched

        if hess is None:
            raise ValueError("adahessian needs the Hutchinson diagonal")
        state["count"] += 1
        b1, b2 = cfg.betas
        adahessian_update_batched(
            params, grads, hess, state["m"], state["v"],
            bias_corrections(state["count"], cfg.betas),
            lr=cfg.lr, b1=b1, b2=b2, denom_pow=cfg.hessian_power / 2.0,
            eps=cfg.eps, lrwd=cfg.lr * cfg.weight_decay)

    return Optimizer(init, step, needs_hessian=True)
