"""Scheduler: wait-queue admission and decode ticking over the slot pool.

A copy of ``repro.serving.scheduler`` (numpy only; tests hold the two to
the same results). The watcher is any object with ``poll()``:
``repro_torch.serving.hotswap.CheckpointWatcher`` in the port.

The :class:`ContinuousEngine` owns the device math and the slot pool; the
scheduler owns *policy*: FIFO admission from a bounded wait queue,
prefill/decode interleaving (at most ``max_admissions_per_tick`` prefills
between decode steps, so a burst of arrivals cannot starve in-flight
requests of decode ticks), per-request deadlines (missed ⇒ the slot is
evicted and reclaimed), and periodic hot-swap polling through an attached
watcher.

Time is **virtual**: the clock advances by the measured wall duration of
each engine call, and request arrivals are timestamps on that clock. A
trace replays identically (modulo machine speed) whether it was recorded
live or synthesized by ``repro_torch.serving.traffic`` — benchmarks and CI
smokes drive the same ``run()`` loop with no sleeping.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: prompt tokens plus its traffic-trace timing."""

    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new: int
    arrival: float = 0.0  # virtual seconds
    deadline: Optional[float] = None  # seconds after arrival; None = none
    eos_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """One finished request with its virtual-clock latency breakdown."""

    rid: int
    tokens: np.ndarray  # (n_generated,) int32
    reason: str  # "eos" | "length" | "evicted" | "rejected"
    arrival: float
    admitted_at: float  # first token exists once admission returns
    finished_at: float

    @property
    def num_tokens(self) -> int:
        return int(np.asarray(self.tokens).size)

    @property
    def ttft(self) -> float:
        """Time to first token: queue wait + prefill."""
        return self.admitted_at - self.arrival

    @property
    def latency(self) -> float:
        return self.finished_at - self.arrival


class Scheduler:
    """Drives one engine over a request stream on a virtual clock."""

    def __init__(self, engine, *, watcher=None, poll_every: int = 8,
                 max_admissions_per_tick: int = 2,
                 max_queue: Optional[int] = None):
        if max_admissions_per_tick < 1:
            raise ValueError("max_admissions_per_tick must be >= 1")
        self.engine = engine
        self.watcher = watcher
        self.poll_every = max(1, poll_every)
        self.max_admissions_per_tick = max_admissions_per_tick
        self.max_queue = max_queue
        self.vnow = 0.0
        self.queue: Deque[Request] = deque()
        self.results: List[RequestResult] = []
        self.rejected = 0
        self._meta: Dict[int, dict] = {}  # rid → {arrival, admitted_at, deadline}
        self._slot_rid: Dict[int, int] = {}

    @property
    def busy(self) -> bool:
        return bool(self.queue) or self.engine.num_active > 0

    def submit(self, req: Request) -> bool:
        """Enqueue a request; False (and a ``rejected`` result) when the
        wait queue is at ``max_queue`` — load shedding, not an error."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.rejected += 1
            self.results.append(RequestResult(
                rid=req.rid, tokens=np.zeros((0,), np.int32),
                reason="rejected", arrival=req.arrival,
                admitted_at=self.vnow, finished_at=self.vnow))
            return False
        self.queue.append(req)
        return True

    def _admit_from_queue(self) -> int:
        """Seat queued requests into vacant slots, bounded per tick."""
        n = 0
        while (self.queue and self.engine.vacant_slots()
               and n < self.max_admissions_per_tick):
            req = self.queue.popleft()
            t0 = time.perf_counter()
            slot = self.engine.admit(
                req.prompt, max_new=req.max_new, eos_id=req.eos_id,
                rid=req.rid)
            self.vnow += time.perf_counter() - t0
            self._slot_rid[slot] = req.rid
            self._meta[req.rid] = {
                "arrival": req.arrival, "admitted_at": self.vnow,
                "deadline": (None if req.deadline is None
                             else req.arrival + req.deadline)}
            n += 1
        return n

    def _evict_deadline_misses(self) -> None:
        for slot in self.engine.active_slots():
            rid = self._slot_rid[slot]
            dl = self._meta[rid]["deadline"]
            if dl is not None and self.vnow > dl:
                self.engine.evict(slot)

    def _collect(self, finished) -> None:
        for f in finished:
            meta = self._meta.pop(f.rid)
            self._slot_rid.pop(f.slot, None)
            self.results.append(RequestResult(
                rid=f.rid, tokens=f.tokens, reason=f.reason,
                arrival=meta["arrival"], admitted_at=meta["admitted_at"],
                finished_at=self.vnow))

    def tick(self) -> List[RequestResult]:
        """One scheduling round: admit (bounded), evict deadline misses,
        one pooled decode step, optional hot-swap poll. Returns the
        results that completed this round."""
        before = len(self.results)
        self._admit_from_queue()
        self._collect(self.engine.drain_finished())  # finished-at-admit
        self._evict_deadline_misses()
        t0 = time.perf_counter()
        finished = self.engine.step()
        self.vnow += time.perf_counter() - t0
        self._collect(finished)
        if self.watcher is not None and self.engine.ticks and \
                self.engine.ticks % self.poll_every == 0:
            self.watcher.poll()
        return self.results[before:]

    def run(self, requests, *, max_ticks: int = 100_000) -> List[RequestResult]:
        """Replay a traffic trace to completion: requests are submitted
        when the virtual clock passes their ``arrival``, then the loop
        ticks until queue and pool drain. ``max_ticks`` bounds runaway
        loops (e.g. an EOS id the model never emits with huge budgets)."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        i = 0
        ticks = 0
        while i < len(pending) or self.busy:
            if ticks >= max_ticks:
                raise RuntimeError(
                    f"scheduler exceeded max_ticks={max_ticks} with "
                    f"{len(pending) - i} unsubmitted, "
                    f"{len(self.queue)} queued, "
                    f"{self.engine.num_active} in flight")
            while i < len(pending) and pending[i].arrival <= self.vnow:
                self.submit(pending[i])
                i += 1
            if not self.busy and i < len(pending):
                # idle gap in the trace: jump the clock to the next arrival
                self.vnow = max(self.vnow, pending[i].arrival)
                continue
            self.tick()
            ticks += 1
        return self.results
