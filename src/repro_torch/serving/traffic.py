"""Synthetic serving traffic: bursty Poisson arrivals, mixed prompts.

A copy of ``repro.serving.traffic`` (numpy only; tests hold the two to the
same traces).

Arrival times come from a two-state Markov-modulated Poisson process —
the classic bursty-traffic model: a background state at ``rate`` req/s
and a burst state at ``burst_factor``× that, with exponentially
distributed dwell times in each. Prompt lengths are drawn uniformly from
``prompt_lens`` and token ids uniformly from the vocab; everything is
derived from one ``numpy`` generator seeded by ``seed``, so a trace is
reproducible request-for-request (asserted in tests — benchmarks compare
continuous vs static on the *same* trace).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.scheduler import Request


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """One synthetic trace's shape."""

    num_requests: int = 32
    rate: float = 4.0  # background arrivals per virtual second
    burst_factor: float = 8.0  # burst-state rate multiplier
    burst_dwell: float = 0.5  # mean seconds spent bursting
    calm_dwell: float = 2.0  # mean seconds between bursts
    prompt_lens: Sequence[int] = (4, 8, 12, 16)
    max_new: int = 16
    vocab_size: int = 1000
    deadline: Optional[float] = None  # per-request, seconds after arrival
    eos_id: Optional[int] = None
    seed: int = 0


def synthetic_traffic(cfg: TrafficConfig) -> List[Request]:
    """A reproducible bursty trace as a list of scheduler Requests."""
    if cfg.num_requests < 1:
        raise ValueError("num_requests must be >= 1")
    if not cfg.prompt_lens:
        raise ValueError("prompt_lens must be non-empty")
    rng = np.random.default_rng(cfg.seed)
    reqs: List[Request] = []
    t = 0.0
    bursting = False
    state_left = rng.exponential(cfg.calm_dwell)
    for rid in range(cfg.num_requests):
        rate = cfg.rate * (cfg.burst_factor if bursting else 1.0)
        gap = rng.exponential(1.0 / rate)
        # flip the MMPP state as many times as the gap walks through
        while gap >= state_left:
            gap -= state_left
            t += state_left
            bursting = not bursting
            state_left = rng.exponential(
                cfg.burst_dwell if bursting else cfg.calm_dwell)
            rate = cfg.rate * (cfg.burst_factor if bursting else 1.0)
            gap = rng.exponential(1.0 / rate)  # redraw at the new rate
        state_left -= gap
        t += gap
        L = int(rng.choice(np.asarray(cfg.prompt_lens)))
        prompt = rng.integers(
            0, cfg.vocab_size, (L,), dtype=np.int64).astype(np.int32)
        reqs.append(Request(
            rid=rid, prompt=prompt, max_new=cfg.max_new, arrival=t,
            deadline=cfg.deadline, eos_id=cfg.eos_id))
    return reqs
