"""Optimizer interface over the trainer's flat worker buffers.

An optimizer is a pair of functions on (k, n) float32 buffers — k workers,
n parameters each, in the layout of ``repro_torch.kernels.flatten``:

    state = opt.init(k, n, device)          # {"count": (k,) int32, ...}
    opt.step(params, grads, state, hess)    # updates params and state in place

``hess`` is the spatially averaged Hutchinson diagonal, passed only to
optimizers with ``needs_hessian`` (AdaHessian). Each update repeats the
reference's ``update`` + ``apply_updates`` arithmetic in the same op order
(``repro.optim``), for all workers at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable   # (k, n, device) -> state dict of (k, ...) tensors
    step: Callable   # (params, grads, state, hess=None) -> None, in place
    needs_hessian: bool = False


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    from repro_torch.optim import adahessian, firstorder

    if cfg.name == "sgd":
        return firstorder.sgd(cfg)
    if cfg.name == "momentum":
        return firstorder.momentum(cfg)
    if cfg.name == "adahessian":
        return adahessian.adahessian(cfg)
    if cfg.name == "adam":
        raise NotImplementedError(
            "optimizer 'adam' is not ported to PyTorch yet (no §VI method "
            "uses it)")
    raise ValueError(f"unknown optimizer {cfg.name!r}")
