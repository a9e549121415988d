"""Data overlap partition (paper §V-A, "data distribution method").

A numpy copy of ``repro.core.overlap``: the same seed gives the same split.

All k workers share a random subset O with |O| = round(r·n); the remainder
D − O is split disjointly:  D_j = O ∪ S_j,  |S_j| = ⌊(n−o)/k⌋. The overlap
ratio r = o/n is the paper's hedge against losing a worker's unique shard
for good: when worker j dies, only S_j's information is at risk, and the
shared O keeps the survivors' gradients correlated enough for the master
to keep improving (§VI uses r = 0.25 at k = 4, 0.125 at k = 8 —
``ElasticConfig.overlap_ratio``).

Host-side (numpy) — this feeds the data pipeline
(``repro_torch.data.pipeline.WorkerBatcher``), not the jitted graph; both
placements consume the same host-built batches, so the partition is
placement-independent by construction.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def overlap_partition(
    n: int, k: int, ratio: float, seed: int = 0
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The §V-A split itself: returns (overlap indices O, [per-worker
    unique index sets S_j]); deterministic in ``seed``.

    O depends only on (n, ratio, seed) — not on k — so re-partitioning
    after a membership change keeps the shared overlap stable and only
    redeals the unique shards S_j among the new pool.

    The ``len(rest) % k`` remainder is dealt round-robin (one extra sample
    to each of the first ``rest % k`` workers) instead of being dropped, so
    every index in D is assigned to at least one worker; when k divides
    evenly the split is unchanged.
    """
    if not 0.0 <= ratio < 1.0:
        raise ValueError(f"overlap ratio must be in [0,1), got {ratio}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    o = int(round(ratio * n))
    overlap = perm[:o]
    rest = perm[o:]
    per, rem = divmod(len(rest), k)
    bounds = np.cumsum([0] + [per + (1 if j < rem else 0)
                              for j in range(k)])
    uniques = [rest[bounds[j]:bounds[j + 1]] for j in range(k)]
    return overlap, uniques


def worker_datasets(n: int, k: int, ratio: float, seed: int = 0
                    ) -> List[np.ndarray]:
    """Each worker's dataset D_j = O ∪ S_j as index arrays (shuffled per
    worker, deterministic) — what the batcher samples worker j's τ local
    steps from each round (§V-A)."""
    overlap, uniques = overlap_partition(n, k, ratio, seed)
    rng = np.random.default_rng(seed + 1)
    out = []
    for j in range(k):
        dj = np.concatenate([overlap, uniques[j]])
        rng.shuffle(dj)
        out.append(dj)
    return out
