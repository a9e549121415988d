"""Elastic-averaging parameter updates (EASGD eqs. 8–9; dynamic eqs. 12–13).

    θ^i ← θ^i − h1 · (θ^i − θ^m)          (worker pulled toward master)
    θ^m ← θ^m + h2 · (θ^i − θ^m)          (master pulled toward worker)

Plain PyTorch versions of the two elastic CUDA kernels
(``repro_torch.kernels.elastic``): CPU tensors and the tests run these, a
CUDA tensor runs the kernel. Both update flat float32 buffers in place and
take their weights as a (2, k) tensor ``[h1; h2]`` on the buffers' device,
so no weight is read back to the host. :func:`elastic_update_grouped` is
the hierarchy's rack exchange: the batched update once per rack.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.dynamic_weight import rack_bounds


def elastic_update(worker: torch.Tensor, master: torch.Tensor,
                   h: torch.Tensor) -> None:
    """Eqs. (12)–(13) for one worker: ``worker``, ``master`` (n,), ``h``
    (2, 1). In place on both."""
    diff = worker - master
    worker.sub_(h[0, 0] * diff)
    master.add_(h[1, 0] * diff)


def elastic_update_batched(workers: torch.Tensor, master: torch.Tensor,
                           h: torch.Tensor,
                           master_ref: Optional[torch.Tensor] = None) -> None:
    """All k worker exchanges plus the master reduction, in place.

    ``workers`` (k, n), ``master`` (n,), ``h`` (2, k). Every worker syncs
    against the same snapshot ``ref`` (the master, or ``master_ref`` under
    delayed averaging) and the pulls accumulate in worker order 0..k−1:

        θ^i ← θ^i − h1_i · (θ^i − θ^ref)
        θ^m ← θ^m + Σ_i h2_i · (θ^i − θ^ref)

    Pass ``dynamic_weight.master_schedule_weights(h2)`` as h2 to reproduce
    the sequential scan's master.
    """
    ref = master if master_ref is None else master_ref
    acc = torch.zeros_like(master)
    for i in range(workers.shape[0]):
        diff = workers[i] - ref
        workers[i].sub_(h[0, i] * diff)
        acc.add_(h[1, i] * diff)
    master.add_(acc)


def elastic_update_grouped(workers: torch.Tensor, submasters: torch.Tensor,
                           h: torch.Tensor, grp: np.ndarray) -> None:
    """Rack exchange of the hierarchy, in place: every worker syncs
    against its rack's sub-master and each sub-master accumulates its
    members' pulls, in worker order within the rack:

        θ^i   ← θ^i   − h1_i · (θ^i − θ^s_{g(i)})
        θ^s_g ← θ^s_g + Σ_{i : g(i)=g} h2_i · (θ^i − θ^s_g)

    ``workers`` (k, n), ``submasters`` (G, n), ``h`` (2, k), ``grp`` the
    static (k,) slot → rack map of contiguous racks. Rack g is the row
    block ``workers[s_g:e_g]``, so its exchange is one
    :func:`elastic_update_batched` on that block."""
    for g, (s, e) in enumerate(rack_bounds(grp, submasters.shape[0])):
        elastic_update_batched(workers[s:e], submasters[g],
                               h[:, s:e].contiguous())
