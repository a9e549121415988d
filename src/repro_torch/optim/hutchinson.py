"""Hutchinson estimator for the Hessian diagonal (paper §IV-B / AdaHessian).

    diag(H) ≈ (1/S) Σ_s  z_s ⊙ (H z_s),   z_s ~ Rademacher

The Hessian-vector product is forward-over-reverse: ``torch.func.jvp`` of
``torch.func.grad(loss)`` returns the gradient as its primal and H·z as its
tangent in one call — the counterpart of the reference's
``hessian_diag_with_grad``, whose ``jax.linearize`` shares one evaluation
of the gradient between the two. ``torch.func.vmap`` maps it over the
worker axis.

The probes are an *input* here, not drawn inside: the trainer obtains them
through one seam (``ElasticTrainer.probe_fn``), so a test can inject the
reference's threefry probes and a stand-alone run draws its own.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch.func import grad, jvp, vmap

Params = Dict[str, torch.Tensor]


def grad_hvp(loss_fn: Callable, params: Params, z: Params, *inputs
             ) -> Tuple[Params, Params, torch.Tensor]:
    """(∇loss, H·z, loss) at ``params`` for one worker; ``loss_fn(params,
    *inputs)`` returns a scalar."""
    def loss_and_value(q):
        value = loss_fn(q, *inputs)
        return value, value

    return jvp(grad(loss_and_value, has_aux=True), (params,), (z,),
               has_aux=True)


def hessian_diag_with_grad(loss_fn: Callable, params: Params,
                           probes: List[Params], *inputs):
    """Batched over a leading worker axis: ``params`` leaves are (k, ...)
    and each entry of ``probes`` (one per Hutchinson sample) holds (k, ...)
    ±1 tangents. Returns ``(grads, diag, loss)``: (k, ...) gradients, the
    (k, ...) float32 Hutchinson diagonal and the (k,) losses.

    Samples accumulate left to right from the first and divide by S only
    when S > 1, the reference's order (``repro.optim.hutchinson``).
    """
    batched = vmap(lambda p, z, *xs: grad_hvp(loss_fn, p, z, *xs))
    grads, acc, loss = None, None, None
    for z in probes:
        g, hz, l = batched(params, z, *inputs)
        one = {name: z[name].float() * hz[name].float() for name in hz}
        if acc is None:
            grads, acc, loss = g, one, l
        else:
            acc = {name: acc[name] + one[name] for name in acc}
    if len(probes) > 1:
        acc = {name: x / len(probes) for name, x in acc.items()}
    return grads, acc, loss
