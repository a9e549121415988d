"""The single-worker train step: the k=1 plain control (``RunSpec.plain``).

The port of ``repro.train.steps.make_train_step`` / ``init_train_state``
for any model with ``loss(params, batch)`` (the paper's CNN, the dense
LMs). State lives in flat float32 buffers in the
reference's leaf order (``repro_torch.kernels.flatten``), updated in
place: ``params`` and the optimizer's ``m``/``v`` are (n,), ``count`` a
0-d int32 tensor, ``step`` a Python int.

One step: loss and gradient, for AdaHessian the Hutchinson diagonal (one
``jvp(grad)``, ``repro_torch.optim.hutchinson``) from probes drawn through
a seam ``probe_fn(step, 0, 0) -> (hutchinson_samples, n)`` like
``ElasticTrainer.probe_fn``, spatially averaged per leaf, then the
optimizer step. AdaHessian's step is the single-worker kernel
(``kernels.adahessian.ops.adahessian_step``: the CUDA kernel on the card,
its plain version on the CPU); with ``weight_decay != 0`` it is the
batched kernel at k=1, which carries the ``lr·wd`` term. SGD, Momentum
and Adam take their optimizers' elementwise steps at k=1.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.func import grad, vmap

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.coordinator import ProbeFn, RademacherProbes
from repro_torch.device import resolve_device
from repro_torch.kernels.adahessian.ops import (adahessian_step,
                                                adahessian_update_batched,
                                                pack_scalars)
from repro_torch.kernels.flatten import FlatLayout
from repro_torch.nn.param import init_tree
from repro_torch.optim.adahessian import bias_corrections, spatial_average
from repro_torch.optim.base import make_optimizer
from repro_torch.optim.hutchinson import hessian_diag_with_grad


def init_train_state(model, opt_cfg: OptimizerConfig, params=None, *,
                     seed: int = 0, device="cuda") -> Dict[str, Any]:
    """``{"params", "opt", "step"}`` on ``device``: ``params`` (a nested
    tree in the reference layout, e.g. from ``params_from_numpy``) or a
    tree drawn from a ``torch.Generator`` seeded with ``seed``, and a fresh
    optimizer state."""
    device = resolve_device(device)
    layout = FlatLayout(model.spec)
    if params is None:
        params = init_tree(torch.Generator().manual_seed(seed), model.spec)
    opt = make_optimizer(opt_cfg).init(1, layout.n, device)
    return {"params": layout.pack_tree(params, device=device),
            "opt": {key: val[0] for key, val in opt.items()}, "step": 0}


def make_train_step(model, opt_cfg: OptimizerConfig, *,
                    probe_fn: Optional[ProbeFn] = None, seed: int = 0,
                    device="cuda"):
    """``train_step(state, batch, step) -> (state, {"loss"})``, in place.
    ``batch`` holds one worker's batch dict on the state's device (the
    CNN's ``images`` (B, 28, 28, 1) float32 and ``labels`` (B,) int64, an
    LM's ``tokens`` and ``targets`` (B, S) int64); ``step`` keys the probe
    seam (None draws ``RademacherProbes`` seeded with ``seed``)."""
    device = resolve_device(device)
    opt = make_optimizer(opt_cfg)
    layout = FlatLayout(model.spec)
    if opt.needs_hessian and probe_fn is None:
        probe_fn = RademacherProbes(seed, layout.n,
                                    opt_cfg.hutchinson_samples, device)
    b1, b2 = opt_cfg.betas

    def loss_fn(p, b):
        return model.loss(p, b)[0]

    def loss_and_value(p, b):
        value = loss_fn(p, b)
        return value, value

    def train_step(state, batch, step: int):
        p, o = state["params"], state["opt"]
        one = {key: val[None] for key, val in batch.items()}
        if opt.needs_hessian:
            z = probe_fn(step, 0, 0)
            probes = [layout.views(z[s][None]) for s in range(z.shape[0])]
            grads, diag, loss = hessian_diag_with_grad(
                loss_fn, layout.views(p[None]), probes, one)
            hs = {name: spatial_average(d, opt_cfg.spatial_block,
                                        batch_dims=1)
                  for name, d in diag.items()}
            g, h = layout.pack(grads, (1,))[0], layout.pack(hs, (1,))[0]
            o["count"] += 1
            if opt_cfg.weight_decay:
                adahessian_update_batched(
                    p[None], g[None], h[None], o["m"][None], o["v"][None],
                    bias_corrections(o["count"][None], opt_cfg.betas),
                    lr=opt_cfg.lr, b1=b1, b2=b2,
                    denom_pow=opt_cfg.hessian_power / 2.0, eps=opt_cfg.eps,
                    lrwd=opt_cfg.lr * opt_cfg.weight_decay)
            else:
                adahessian_step(p, g, h, o["m"], o["v"],
                                pack_scalars(opt_cfg, o["count"]))
        else:
            grads, loss = vmap(grad(loss_and_value, has_aux=True))(
                layout.views(p[None]), one)
            opt.step(p[None], layout.pack(grads, (1,)),
                     {key: val[None] for key, val in o.items()})
        state["step"] += 1
        return state, {"loss": loss[0]}

    return train_step
