"""First-order optimizers: SGD (EASGD's local rule), Momentum (EAMSGD's), Adam."""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.adahessian import bias_corrections
from repro_torch.optim.base import Optimizer


def _count(k, device):
    return torch.zeros(k, dtype=torch.int32, device=device)


def sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(k, n, device):
        return {"count": _count(k, device)}

    def step(params, grads, state, hess=None):
        params.add_(grads * -cfg.lr)          # u = −lr·g; p ← p + u
        state["count"] += 1

    return Optimizer(init, step)


def momentum(cfg: OptimizerConfig) -> Optimizer:
    def init(k, n, device):
        return {"count": _count(k, device),
                "m": torch.zeros(k, n, dtype=torch.float32, device=device)}

    def step(params, grads, state, hess=None):
        m = state["m"]
        m.mul_(cfg.momentum).sub_(grads * cfg.lr)   # m ← μ·m − lr·g
        params.add_(m)                               # p ← p + m
        state["count"] += 1

    return Optimizer(init, step)


def adam(cfg: OptimizerConfig) -> Optimizer:
    """Adam, in the reference's op order (``repro.optim.firstorder.adam``):
    m ← β1·m + (1−β1)·g, v ← β2·v + (1−β2)·g², then
    p ← p − lr·(m/bc1) / (√(v/bc2) + ε) with per-worker bias corrections."""
    b1, b2 = cfg.betas

    def init(k, n, device):
        z = lambda: torch.zeros(k, n, dtype=torch.float32, device=device)
        return {"count": _count(k, device), "m": z(), "v": z()}

    def step(params, grads, state, hess=None):
        state["count"] += 1
        bc = bias_corrections(state["count"], cfg.betas)
        m, v = state["m"], state["v"]
        m.mul_(b1).add_(grads * (1 - b1))
        v.mul_(b2).add_(torch.square(grads) * (1 - b2))
        params.add_(-cfg.lr * (m / bc[0][:, None])
                    / (torch.sqrt(v / bc[1][:, None]) + cfg.eps))

    return Optimizer(init, step)
