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
+score_clip (beyond-paper robustness clamp; 0 keeps the paper's maps).

Every quantity stays on the buffers' device: the comm phase reads nothing
back to the host. The expressions follow ``repro.core.dynamic_weight``.
"""
from __future__ import annotations

from typing import Optional

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


def weights_for(cfg: ElasticConfig, a: torch.Tensor, *,
                failed_recently: Optional[torch.Tensor] = None):
    """(h1, h2) for a raw score; supports fixed-α and oracle modes."""
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
    return w1, w2


def comm_scores_batched(cfg: ElasticConfig, workers: torch.Tensor,
                        master: torch.Tensor, u_hist: torch.Tensor,
                        layout: FlatLayout, *, c: torch.Tensor,
                        failed_recently=None, stale_master=None,
                        straggle=None):
    """Fused-mode scoring for all k workers against one master snapshot:
    ``(u, hist_new, a, w1, w2)``, each with a leading (k,) axis.
    ``straggle`` (k,) bool + ``stale_master``: straggling workers measure
    their distance against the stale snapshot instead."""
    u = log_distance(workers, master, layout)
    if straggle is not None and stale_master is not None:
        u = torch.where(straggle, log_distance(workers, stale_master, layout),
                        u)
    hist_new = push_history(u_hist, u)
    a = raw_score(hist_new, c)
    w1, w2 = weights_for(cfg, a, failed_recently=failed_recently)
    return u, hist_new, a, w1, w2
