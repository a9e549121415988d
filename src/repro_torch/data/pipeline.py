"""Overlap-aware multi-worker batch pipeline (paper §V-A → training rounds).

A numpy copy of ``repro.data.pipeline.WorkerBatcher``: for the same seeds
it emits byte-identical round batches.

Given a dataset of n examples and a worker pool, builds the D_j = O ∪ S_j
partition over the *live* workers and yields per-round batch stacks shaped
(τ, cap, B, ...) for the coordinator's local phase — ``cap`` is the slot
capacity (``ElasticConfig.cap``), so the device-side shapes never change
when membership does. Vacant slots are padded with zero batches (their
local phase is frozen by the active mask; the pad is never trained on).

Membership: ``set_active(slots)`` re-partitions the data over a
new live set. The shared overlap O depends only on (n, ratio, seed) — not
on the worker count — so it is stable across resizes; only the unique
shards S_j are redealt. Each *slot* keeps its own persistent RNG stream,
so a run's batch sequence is deterministic given (seed, membership path).

Deterministic per (seed, round); with the full capacity live this emits
exactly the fixed-k stacks the pre-membership pipeline did.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.configs.base import ElasticConfig
from repro_torch.core.overlap import worker_datasets


class _SlotMixin:
    """Shared slot bookkeeping: which of the ``cap`` slots are live, one
    persistent RNG per slot, and zero-padding for vacant slots."""

    def _init_slots(self, rng_base: int):
        self.cap = self.ecfg.cap
        self.rngs = [np.random.default_rng(self.seed + rng_base + j)
                     for j in range(self.cap)]
        self._pad = None
        self.active = ()
        self.set_active(range(self.ecfg.num_workers))

    def set_active(self, slots: Sequence[int]):
        """Re-partition D over the live slots (ascending order). O stays
        fixed; the unique shards are redealt ``worker_datasets``-style over
        ``len(slots)`` workers, assigned to the live slots in order."""
        slots = tuple(sorted(int(s) for s in slots))
        if not slots:
            raise ValueError("at least one live slot required")
        if slots[0] < 0 or slots[-1] >= self.cap:
            raise ValueError(f"slots {slots} outside capacity {self.cap}")
        self.active = slots
        self._repartition()

    def _zero_batch(self, like: Dict[str, np.ndarray]):
        if self._pad is None:
            self._pad = {key: np.zeros_like(v) for key, v in like.items()}
        return self._pad

    def _stack_round(self, tau: int) -> Dict[str, np.ndarray]:
        """(τ, cap, B, ...) stacks: live slots draw real batches in slot
        order, vacant slots carry the zero pad."""
        live = set(self.active)
        outs = [[self._slot_batch(j) if j in live else None
                 for j in range(self.cap)] for _ in range(tau)]
        pad = self._zero_batch(next(b for b in outs[0] if b is not None))
        return {
            key: np.stack([np.stack([(outs[t][j] or pad)[key]
                                     for j in range(self.cap)])
                           for t in range(tau)])
            for key in pad
        }


@dataclasses.dataclass
class WorkerBatcher(_SlotMixin):
    """Classification pipeline over (images, labels)."""

    images: np.ndarray
    labels: np.ndarray
    ecfg: ElasticConfig
    batch_size: int = 64
    seed: int = 0

    def __post_init__(self):
        self._init_slots(rng_base=100)

    def _repartition(self):
        parts = worker_datasets(len(self.images), len(self.active),
                                self.ecfg.overlap_ratio, self.seed)
        self.indices = {}
        self.cursors = {}
        for slot, part in zip(self.active, parts):
            idx = part.copy()
            self.rngs[slot].shuffle(idx)
            self.indices[slot] = idx
            self.cursors[slot] = 0

    def _slot_batch(self, j: int):
        idx = self.indices[j]
        b = self.batch_size
        if self.cursors[j] + b > len(idx):
            self.rngs[j].shuffle(idx)
            self.cursors[j] = 0
        sel = idx[self.cursors[j]:self.cursors[j] + b]
        self.cursors[j] += b
        return {"images": self.images[sel], "labels": self.labels[sel]}

    def round_batches(self) -> Dict[str, np.ndarray]:
        """(τ, cap, B, ...) stacks for one communication round."""
        return self._stack_round(self.ecfg.tau)
