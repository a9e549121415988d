"""First-order optimizers: SGD (EASGD's local rule) and Momentum (EAMSGD's)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig
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
