"""Dynamic weighting (paper §V-B), on the trainer's flat buffers.

Raw score from the trend of log-distances between a worker and the estimated
master model, then piece-wise-linear maps h1/h2 replacing EASGD's fixed α:

    u_t^i = log ||θ_t^i − θ̃_t^m||
    a_t^i = Σ_j c_j (u_{t−j} − u_{t−j−1}),  Σ c_j = 1, c_0 weights the newest

    h1(a) = 1                     a < k        (snap worker to master)
          = 1 + (1−α)/k · (a−k)   k ≤ a ≤ 0    (linear 1 → α)
          = α                     a > 0        (EASGD behaviour)

    h2(a) = 0                     a < k        (master ignores worker)
          = −α/k · a + α          k ≤ a ≤ 0    (linear 0 → α)
          = α                     a > 0

with threshold k < 0. Worker update uses h1, master update uses h2
(eqs. 12–13). ``ElasticConfig.score_clip > 0`` zeroes h2 for scores above
+score_clip (beyond-paper robustness clamp; 0 keeps the paper's maps), and
``ElasticConfig.u_zclip > 0`` zeroes it for a worker whose u sits more than
u_zclip robust z-scores above the pool (:func:`robust_zscore`; batched
scoring only, as in the reference).

Hierarchical averaging (tree-EASGD) adds the rack helpers: the static
slot → rack map :func:`group_assignment`, the per-rack event-order weights
:func:`master_schedule_weights_grouped`, and :func:`log_distance_grouped`,
each worker measured against its own rack's sub-master.

Every quantity stays on the buffers' device: the comm phase reads nothing
back to the host. The expressions follow ``repro.core.dynamic_weight``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ElasticConfig
from repro_torch.kernels.flatten import FlatLayout


def h1(a, alpha: float, k: float):
    mid = 1.0 + (1.0 - alpha) / k * (a - k)
    return torch.where(a < k, 1.0, torch.where(a <= 0.0, mid, alpha))


def h2(a, alpha: float, k: float):
    mid = -alpha / k * a + alpha
    return torch.where(a < k, 0.0, torch.where(a <= 0.0, mid, alpha))


def log_distance(worker: torch.Tensor, master: torch.Tensor,
                 layout: FlatLayout) -> torch.Tensor:
    """u = log ||θ_i − θ̃_m|| over the whole tree. ``worker`` is (n,) or
    (k, n) against the (n,) ``master``; returns () or (k,).

    The squared norm is summed per leaf, then over leaves in layout order,
    as the reference sums its pytree: one sum over the whole flat buffer
    would reassociate and move u by ulps."""
    d = worker - master
    sq = 0
    for leaf in layout.leaves:
        sq = sq + torch.square(d[..., leaf.offset:leaf.offset + leaf.size]
                               ).sum(-1)
    return torch.log(torch.sqrt(sq) + 1e-30)


def group_assignment(capacity: int, groups: int) -> np.ndarray:
    """Static slot → rack map of the hierarchy: ``capacity`` slots split
    into ``min(groups, capacity)`` contiguous near-equal blocks,
    ``grp[i] = i·G // C`` (numpy int32; the same split the correlated
    failure scenario uses, so a rack outage takes out whole racks)."""
    g = min(groups, capacity)
    return ((np.arange(capacity) * g) // capacity).astype(np.int32)


def rack_bounds(grp: np.ndarray, n_groups: int) -> List[Tuple[int, int]]:
    """``[(start, end), ...]``: the row block of each rack of ``grp``.
    Raises unless ``grp`` is ``n_groups`` contiguous, non-empty racks
    numbered 0, 1, … in slot order: the grouped exchange runs one batched
    update per block."""
    grp = np.asarray(grp).reshape(-1)
    starts = np.flatnonzero(np.r_[True, grp[1:] != grp[:-1]])
    ends = np.r_[starts[1:], grp.shape[0]]
    if not np.array_equal(grp[starts], np.arange(n_groups)):
        raise ValueError(f"rack map {grp.tolist()} is not {n_groups} "
                         "contiguous racks numbered in slot order")
    return [(int(s), int(e)) for s, e in zip(starts, ends)]


def log_distance_grouped(workers: torch.Tensor, submasters: torch.Tensor,
                         grp: np.ndarray, layout: FlatLayout
                         ) -> torch.Tensor:
    """(k,) u of every worker against its own rack's sub-master: one
    :func:`log_distance` per rack over the rack's rows, so the per-leaf
    summation order is :func:`log_distance`'s and no (k, n) gather of the
    sub-masters is built."""
    return torch.cat([log_distance(workers[s:e], submasters[g], layout)
                      for g, (s, e) in enumerate(
                          rack_bounds(grp, submasters.shape[0]))])


def push_history(hist: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """hist: (..., p) oldest→newest rolling window."""
    return torch.cat([hist[..., 1:], u[..., None]], dim=-1)


def score_coefficients(weights, window: int, device=None) -> torch.Tensor:
    """The c_j of :func:`raw_score` for a ``window``-long history: the
    first min(len(weights), window − 1), normalised to sum 1 (float32).
    Built once per trainer, so scoring copies nothing to the device."""
    c = torch.as_tensor(weights, dtype=torch.float32, device=device)
    n = min(c.shape[0], window - 1)
    return c[:n] / torch.sum(c[:n])


def raw_score(hist: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """hist: (..., p); ``c`` from :func:`score_coefficients`, c_0 applied
    to the newest of the p−1 diffs."""
    diffs = hist[..., 1:] - hist[..., :-1]  # oldest→newest, (p−1,)
    return (diffs.flip(-1)[..., :c.shape[0]] * c).sum(-1)


def master_schedule_weights(w2: torch.Tensor) -> torch.Tensor:
    """Event-order-equivalent master weights g_i = h2_i · Π_{j>i}(1 − h2_j):
    the batched reduction with g reproduces the sequential scan's master
    (up to float associativity)."""
    rev = (1.0 - w2).flip(0)
    excl = torch.cat([torch.ones_like(rev[:1]), torch.cumprod(rev[:-1], 0)])
    return w2 * excl.flip(0)


def master_schedule_weights_grouped(w2: torch.Tensor, grp: np.ndarray
                                    ) -> torch.Tensor:
    """Per-rack event-order weights g_i = h2_i · Π_{j>i, grp[j]=grp[i]}
    (1 − h2_j): each sub-master's reduction reproduces a sequential scan of
    its own rack. The reference's masked O(k²) product over scalars."""
    grp = torch.as_tensor(np.asarray(grp), device=w2.device)
    idx = torch.arange(w2.shape[0], device=w2.device)
    later_same = (idx[None, :] > idx[:, None]) & (grp[None, :] == grp[:, None])
    om = 1.0 - w2
    excl = torch.prod(torch.where(later_same, om[None, :], 1.0), dim=1)
    return w2 * excl


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D tensor, on its device: NaN entries are
    ignored, and an even count of the rest gives 0.5·lo + 0.5·hi of the
    two middle values, in the reference's order (``jnp.nanquantile``,
    linear method; ``torch.nanquantile`` interpolates as lo + w·(hi − lo),
    which can differ in the last bit)."""
    s = torch.sort(x).values  # NaN sorts last
    count = (~torch.isnan(x)).sum().to(torch.float32)
    q = 0.5 * (count - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1.0 - w_hi
    top = (count - 1.0).clamp_min(0.0)
    lo = torch.minimum(lo, top).clamp_min(0.0).long()
    hi = torch.minimum(hi, top).clamp_min(0.0).long()
    return s[lo] * w_lo + s[hi] * w_hi


def robust_zscore(u: torch.Tensor, live: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Robust z-score of each u against the live pool's u distribution:
    (u − median) / (1.4826·MAD + 1e-6), median and MAD over live, non-NaN
    entries (``repro.core.dynamic_weight.robust_zscore``). A NaN u gets a
    NaN z, which the clamp in :func:`weights_for` refuses."""
    u = u.to(torch.float32)
    masked = u if live is None else torch.where(live, u, float("nan"))
    med = _nanmedian(masked)
    mad = _nanmedian(torch.abs(masked - med))
    return (u - med) / (1.4826 * mad + 1e-6)


def weights_for(cfg: ElasticConfig, a: torch.Tensor, *,
                failed_recently: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None):
    """(h1, h2) for a raw score; supports fixed-α and oracle modes.

    Dynamic mode applies the two robustness clamps on w2: ``score_clip``
    (a score above it, or a non-finite one, is refused) and, when the (k,)
    log-distances ``u`` of the whole pool are given, ``u_zclip`` (a worker
    more than u_zclip robust z-scores above the live pool — ``live`` masks
    it, ``None`` is all live — is refused; a NaN z is refused too). The
    sequential scan passes no ``u``."""
    if cfg.oracle:
        assert failed_recently is not None
        return (torch.where(failed_recently, 1.0, cfg.alpha),
                torch.where(failed_recently, 0.0, cfg.alpha))
    if not cfg.dynamic:
        one = torch.ones_like(a)
        return cfg.alpha * one, cfg.alpha * one
    w1 = h1(a, cfg.alpha, cfg.score_k)
    w2 = h2(a, cfg.alpha, cfg.score_k)
    if cfg.score_clip > 0:
        # `a <= clip keeps w2`, so a non-finite score is refused too
        w2 = torch.where(a <= cfg.score_clip, w2, 0.0)
    if cfg.u_zclip > 0 and u is not None:
        w2 = torch.where(robust_zscore(u, live) <= cfg.u_zclip, w2, 0.0)
    return w1, w2


def comm_scores_batched(cfg: ElasticConfig, workers: torch.Tensor,
                        master: torch.Tensor, u_hist: torch.Tensor,
                        layout: FlatLayout, *, c: torch.Tensor,
                        failed_recently=None, stale_master=None,
                        straggle=None, active=None):
    """Fused-mode scoring for all k workers against one master snapshot:
    ``(u, hist_new, a, w1, w2)``, each with a leading (k,) axis.
    ``straggle`` (k,) bool + ``stale_master``: straggling workers measure
    their distance against the stale snapshot instead. With
    ``cfg.u_zclip > 0`` the u of the live pool (``active``, (k,) bool;
    ``None``: every slot) feed the absolute-distance clamp."""
    u = log_distance(workers, master, layout)
    if straggle is not None and stale_master is not None:
        u = torch.where(straggle, log_distance(workers, stale_master, layout),
                        u)
    hist_new = push_history(u_hist, u)
    a = raw_score(hist_new, c)
    w1, w2 = weights_for(cfg, a, failed_recently=failed_recently, u=u,
                         live=active)
    return u, hist_new, a, w1, w2
