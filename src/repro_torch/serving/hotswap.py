"""Live checkpoint hot-swap: track a running training session's master.

The port of ``repro.serving.hotswap``. The artifact being served is the
elastic master, which a live training session keeps rewriting. The
watcher polls that checkpoint directory between decode steps, detects a
new save via :func:`checkpoint.read_fingerprint` (manifest mtime + size;
the manifest is written after the shards, so a fresh fingerprint means
the shards it indexes are complete), checks the arch against the
engine's config via :func:`checkpoint.read_metadata`, restores the
params into a **standby** tree on the engine's device and in its dtypes,
and flips them in with ``ContinuousEngine.swap_params``: in-flight
requests keep decoding on their existing KV.

Serving a one-checkpoint-stale master while the restore runs is the
tolerance that makes delayed averaging work in training: the master
moves slowly against any single update. The poll is synchronous, between
scheduler ticks, as in the reference; a restore therefore takes its time
out of the tick that polls.

Every poll that changes anything is journalled as a :class:`SwapEvent`,
so a serving run's whole swap story is replayable from ``watcher.log``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """Journal entry: one poll that found a new checkpoint (or rejected
    one)."""

    tick: int  # engine decode tick when the poll ran
    fingerprint: str
    applied: bool
    rounds: Optional[int] = None  # training rounds recorded in metadata
    arch: str = ""
    note: str = ""


class CheckpointWatcher:
    """Polls one checkpoint dir and hot-swaps an engine's params.

    ``poll()`` is meant to run between decode steps (the scheduler calls
    it every ``poll_every`` ticks); it does nothing unless the
    fingerprint moved. The restore takes ``like=engine.params``, so the
    standby tree arrives in the live tree's structure, dtypes and device,
    which ``swap_params`` checks leaf for leaf.
    """

    def __init__(self, engine, path: str, *,
                 expect_arch: Optional[str] = None):
        self.engine = engine
        self.path = path
        # None → swap regardless of recorded arch (metadata-less ckpts)
        self.expect_arch = (expect_arch if expect_arch is not None
                            else engine.model.cfg.name)
        self.log: List[SwapEvent] = []
        # the engine's params are taken to reflect what is on disk at
        # attach time (launch/serve.py restores before building the
        # watcher), so the current fingerprint is the baseline
        self._seen = checkpoint.read_fingerprint(path)

    @property
    def swaps_applied(self) -> int:
        return sum(e.applied for e in self.log)

    def poll(self) -> bool:
        """One poll; True iff a swap was applied."""
        fp = checkpoint.read_fingerprint(self.path)
        if fp is None or fp == self._seen:
            return False
        meta = checkpoint.read_metadata(self.path)
        arch = str(meta.get("arch", ""))
        if self.expect_arch is not None and arch != self.expect_arch:
            self._seen = fp
            self.log.append(SwapEvent(
                tick=self.engine.ticks, fingerprint=fp, applied=False,
                rounds=meta.get("rounds"), arch=arch,
                note=f"arch mismatch: checkpoint {arch!r} != engine "
                     f"{self.expect_arch!r}"))
            return False
        standby, meta = checkpoint.restore(self.path, like=self.engine.params)
        if checkpoint.read_fingerprint(self.path) != fp:
            # a new save raced the restore: skip; the next poll sees the
            # newer fingerprint and restores that generation instead
            self.log.append(SwapEvent(
                tick=self.engine.ticks, fingerprint=fp, applied=False,
                rounds=meta.get("rounds"), arch=arch,
                note="checkpoint changed during restore; deferred"))
            return False
        self.engine.swap_params(standby)
        self._seen = fp
        self.log.append(SwapEvent(
            tick=self.engine.ticks, fingerprint=fp, applied=True,
            rounds=meta.get("rounds"), arch=arch))
        return True
