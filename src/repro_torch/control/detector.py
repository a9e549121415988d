"""Failure/straggler detection from observable telemetry only.

The paper's §VI machinery — and every open-loop scenario run — hands
the coordinator ground-truth masks. Production has no such oracle: a
parameter server sees only what the training loop itself emits. This
detector closes that gap. It consumes exactly the host-observable fields of
each ``RoundRecord``:

- ``u`` — per-slot log-distance to the master (§V-B); its per-round
  increment ``du`` carries the failure signature (below).
- ``loss_w`` — per-slot mean local-phase loss; a persistently lagging slot
  sits above the pool's EWMA level.
- ``round_ms`` — host wall time of the round (round-level, not per-slot:
  one round executes all slots, so a slow round corroborates a slot-level
  suspicion but cannot name the slot by itself).
- ``active`` — the session's *own* membership decisions (not an oracle
  signal: the controller made them).

It never reads the schedule's ground-truth masks — ``tests/test_control.py``
enforces this both statically (source scan) and at runtime (records whose
mask fields raise on access).

Failure signature (calibrated empirically on detector-blind telemetry —
the thresholds below come from sweeping crash/straggler/burst scenario runs
across seeds, see tests/test_control.py):

A live worker is *pulled back* toward the master every round it syncs (the
h1·α elastic term), so its ``du`` sequence keeps flipping sign — drift up,
yank down. A worker whose communication is cut keeps drifting but is never
yanked, which shows up in one of two ways depending on where it died:

- **adrift** (near the master): ``du`` stays solidly positive round after
  round — ``du > pull_eps`` *and* not below the live pool's median
  (``du - median > -rel_margin``; the cross-sectional term is what
  separates a cut worker from rounds where the whole pool drifts up
  because the master moved). ``drift_rounds`` consecutive such rounds →
  failed-suspect. The strict positivity floor matters: healthy slots
  hovering at their elastic equilibrium emit runs of *weak* positives,
  and only the floor separates those from genuine cut-drift.
- **silent** (far from the master): the distance is so large that local
  drift barely moves ``log‖θ−master‖`` — ``|du|`` collapses below a
  pool-relative floor (``max(freeze_eps, silent_ratio·median|du|)``)
  while the pool is mobile (median live |du| > ``mobile_du``; the gate
  keeps a uniformly-quiet converged pool from mass-flagging).
  ``suspect_rounds`` consecutive → failed-suspect. The relative floor is
  what catches early-run cuts: a slot ticking along at |du| ≈ 0.04 is
  unremarkable in a calm pool but glaringly frozen while everyone else
  moves by ≈ 1.0.

Byzantine slots trip **adrift** too, for the same mechanical
reason a cut worker does: once ``ElasticConfig.score_clip`` makes the
master refuse a gradient-corrupted worker's pulls, that worker drifts
without the yank-back, and ``du`` goes solidly positive. Measured on the
acceptance regime (noise-mode corruption, byzantine_frac=0.5,
score_clip=0.5, seeds 1–3, 20 rounds): 5/5 corrupt slots flagged
failed-suspect, ≤ 2 false flags per run — the FPs cluster in rounds 9–11
where the clip's warm-up freeze (every slot starts refused while the
score history fills) leaves honest slots with unusually jumpy telemetry.
Without the clip the detector largely misses noise-mode corruption: the
full-α elastic pull holds the noisy worker at a fixed elevated distance,
``du`` keeps flipping sign, and no drift accumulates — the clip is what
converts "polluting the master" into the observable cut-drift signature
(``tests/test_control.py::TestDetectorSweep`` encodes both floors).

Scope: both rules lean on cross-sectional statistics of the live pool
(median du, pool mobility), which assumes a strict *minority* of the pool
is faulty at once. When half or more of the live slots fail concurrently,
the median itself drifts and the adrift margin can stall for a few rounds
— the slot is still caught once the pool re-anchors, just later (observed
on crash seeds with two overlapping episodes in a k=4 pool). Correlated
whole-rack bursts need rack-level detectors (see the hierarchical-master
roadmap item); ``tests/test_control.py`` encodes exactly this contract.

**Straggler-suspect** is the conservative companion rule: the slot's
EWMA(u) sits ``slow_z`` robust-z below the live pool (it completes fewer
local steps per round, so it hugs the master), or its EWMA(loss_w) sits
``slow_loss_z`` above (slower progress); a wall-time-outlier round halves
the bar. Transient per-round straggles are *not* reliably observable in
this telemetry — the rule is tuned to fire on persistent laggards and stay
quiet otherwise (the paper's dynamic weighting already down-weights mild
stragglers without eviction).

Hysteresis. A slot must look suspect K consecutive rounds before its
verdict flips — one noisy round never flaps the pool — and a flag on a
live slot clears only after ``clear_rounds`` consecutive calm rounds. Once
the policy evicts a flagged slot its telemetry goes dark (vacant slots
report frozen values), so recovery cannot be *observed*; instead the flag
ages out after ``readmit_cooldown`` dark rounds and the verdict returns to
healthy, which the policy reads as "probe-ready": it readmits the slot,
the join re-seats it from the master, and if it is still broken the
renewed drift re-flags it K rounds later. Slots that (re)join have their
rolling state reset — a cold-started slot's first round is not evidence.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# Per-slot health verdicts.
HEALTHY = "healthy"
STRAGGLER_SUSPECT = "straggler_suspect"
FAILED_SUSPECT = "failed_suspect"
VERDICTS = (HEALTHY, STRAGGLER_SUSPECT, FAILED_SUSPECT)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Thresholds and hysteresis constants (documented in
    calibration described in the module docstring).

    ``suspect_rounds`` is K for the silent rule, ``drift_rounds`` K for the
    adrift rule, ``clear_rounds`` the calm streak that clears a live flag,
    and ``readmit_cooldown`` how many dark rounds an evicted slot stays
    flagged before its verdict returns to healthy (probe-ready).
    ``pull_eps``/``rel_margin`` define adrift evidence (positive drift, not
    below the pool median); ``freeze_eps``/``silent_ratio``/``mobile_du``
    define silent evidence (pool-relatively frozen u while the pool
    moves). ``slow_z``/``slow_loss_z``
    are robust-z thresholds on the EWMA(u)/EWMA(loss_w) level vs the live
    pool (straggler rule) with ``ewma_beta`` the history weight;
    ``round_ms_z`` marks a wall-time-outlier round, which halves the
    straggler bar. ``min_stat_slots`` is the smallest live pool the
    cross-sectional statistics are trusted on; ``mad_floor`` keeps the z
    denominators sane when the pool is tightly clustered (it is relative:
    floor = mad_floor·|median|, with an absolute backstop).
    """

    suspect_rounds: int = 2
    drift_rounds: int = 3
    clear_rounds: int = 2
    readmit_cooldown: int = 3
    pull_eps: float = 0.02
    rel_margin: float = 0.02
    freeze_eps: float = 0.02
    silent_ratio: float = 0.1
    mobile_du: float = 0.04
    slow_z: float = 3.0
    slow_loss_z: float = 3.0
    ewma_beta: float = 0.5
    round_ms_z: float = 3.0
    min_stat_slots: int = 3
    mad_floor: float = 0.10
    time_window: int = 8  # rolling round_ms window for the wall-time gate


class FailureDetector:
    """Rolling per-slot health state machine over observed round records.

    Feed rounds in order with :meth:`observe`; read :meth:`verdicts` (one
    of :data:`VERDICTS` per slot) between chunks. ``capacity`` fixes the
    slot count up front so the detector works on a padded pool too.
    """

    def __init__(self, capacity: int,
                 config: Optional[DetectorConfig] = None):
        self.cfg = config or DetectorConfig()
        self.capacity = capacity
        self.round = -1  # last observed round
        self._u_prev = np.full(capacity, np.nan)
        self._ewma_u = np.full(capacity, np.nan)
        self._ewma_loss = np.full(capacity, np.nan)
        self._silent_streak = np.zeros(capacity, np.int64)
        self._adrift_streak = np.zeros(capacity, np.int64)
        self._slow_streak = np.zeros(capacity, np.int64)
        self._calm_streak = np.zeros(capacity, np.int64)
        # committed flag per slot: None | STRAGGLER_SUSPECT | FAILED_SUSPECT
        self._flag: List[Optional[str]] = [None] * capacity
        self._dark_since = np.full(capacity, -1, np.int64)  # evict round
        self._prev_active = np.ones(capacity, bool)
        self._round_ms_hist: List[float] = []
        # (round, slot, verdict) transitions, for logging/inspection
        self.events: List[tuple] = []

    # -- helpers -------------------------------------------------------------
    def _robust_z(self, x: np.ndarray, sel: np.ndarray) -> np.ndarray:
        """z-scores of x against the median/MAD of x[sel]; zeros when too
        few finite samples are selected for the statistics to mean
        anything."""
        sel = sel & np.isfinite(x)
        z = np.zeros_like(x, dtype=float)
        if sel.sum() < 2:
            return z
        med = np.median(x[sel])
        mad = np.median(np.abs(x[sel] - med))
        scale = max(1.4826 * mad, self.cfg.mad_floor * abs(med), 1e-3)
        out = (x - med) / scale
        z[np.isfinite(out)] = out[np.isfinite(out)]
        return z

    def _set_flag(self, i: int, flag: Optional[str], r: int):
        if self._flag[i] != flag:
            self._flag[i] = flag
            self.events.append((r, i, flag or HEALTHY))

    def _reset_slot(self, i: int):
        self._u_prev[i] = np.nan
        self._ewma_u[i] = np.nan
        self._ewma_loss[i] = np.nan
        self._silent_streak[i] = 0
        self._adrift_streak[i] = 0
        self._slow_streak[i] = 0
        self._calm_streak[i] = 0
        self._dark_since[i] = -1

    # -- main entry ----------------------------------------------------------
    def observe(self, record) -> None:
        """Consume one round's observable telemetry (in round order)."""
        cfg = self.cfg
        r = int(record.round)
        self.round = r
        act = (np.asarray(record.active, bool)
               if record.active is not None
               else np.ones(self.capacity, bool))
        u = np.asarray(record.u, float)
        loss_w = (np.asarray(record.loss_w, float)
                  if getattr(record, "loss_w", None) is not None
                  else np.full(self.capacity, np.nan))

        # a slot that just (re)joined cold-starts its rolling state: its
        # first round back is a master-re-seated step, not evidence
        for i in np.flatnonzero(act & ~self._prev_active):
            self._reset_slot(i)

        # round-level wall-time outlier (corroboration, not attribution)
        slow_round = False
        ms = float(getattr(record, "round_ms", 0.0) or 0.0)
        if ms > 0.0:
            hist = self._round_ms_hist
            if len(hist) >= 4:
                med = float(np.median(hist))
                mad = max(1.4826 * float(np.median(np.abs(
                    np.asarray(hist) - med))), 1e-3 * max(med, 1e-9))
                slow_round = (ms - med) / mad > cfg.round_ms_z
            hist.append(ms)
            if len(hist) > cfg.time_window:
                del hist[0]

        du = u - self._u_prev
        known = act & np.isfinite(du)
        enough = int(act.sum()) >= cfg.min_stat_slots
        if known.sum() >= 2:
            du_med = float(np.median(du[known]))
            du_meda = float(np.median(np.abs(du[known])))
            pool_mobile = du_meda > cfg.mobile_du
        else:
            du_med = 0.0
            du_meda = 0.0
            pool_mobile = False
        silent_floor = max(cfg.freeze_eps, cfg.silent_ratio * du_meda)

        b = cfg.ewma_beta
        ew_u = np.where(np.isfinite(self._ewma_u),
                        b * self._ewma_u + (1 - b) * u, u)
        ew_l = np.where(np.isfinite(self._ewma_loss) & np.isfinite(loss_w),
                        b * self._ewma_loss + (1 - b) * loss_w, loss_w)
        z_u = self._robust_z(ew_u, act)
        z_l = self._robust_z(ew_l, act)

        slow_bar = cfg.slow_z * (0.5 if slow_round else 1.0)
        loss_bar = cfg.slow_loss_z * (0.5 if slow_round else 1.0)
        for i in range(self.capacity):
            if not act[i]:
                # dark slot: if we flagged it and it left the pool, age the
                # flag out so the policy can probe-readmit it
                if self._flag[i] is not None:
                    if self._dark_since[i] < 0:
                        self._dark_since[i] = r
                    elif r - self._dark_since[i] >= cfg.readmit_cooldown:
                        self._set_flag(i, None, r)
                        self._dark_since[i] = -1
                continue
            if not np.isfinite(du[i]):
                continue  # first observed round for this slot: no drift yet
            silent = pool_mobile and abs(du[i]) < silent_floor
            adrift = (not silent and enough and du[i] > cfg.pull_eps
                      and du[i] - du_med > -cfg.rel_margin)
            lagging = (not (silent or adrift) and enough
                       and (z_u[i] < -slow_bar or z_l[i] > loss_bar))
            self._silent_streak[i] = (self._silent_streak[i] + 1
                                      if silent else 0)
            self._adrift_streak[i] = (self._adrift_streak[i] + 1
                                      if adrift else 0)
            self._slow_streak[i] = self._slow_streak[i] + 1 if lagging else 0
            calm = not (silent or adrift or lagging)
            self._calm_streak[i] = self._calm_streak[i] + 1 if calm else 0

            failed_now = (self._silent_streak[i] >= cfg.suspect_rounds
                          or self._adrift_streak[i] >= cfg.drift_rounds)
            if self._flag[i] is None:
                if failed_now:
                    self._set_flag(i, FAILED_SUSPECT, r)
                elif self._slow_streak[i] >= cfg.suspect_rounds:
                    self._set_flag(i, STRAGGLER_SUSPECT, r)
            else:
                # escalate a straggler flag if the slot stops syncing
                if self._flag[i] == STRAGGLER_SUSPECT and failed_now:
                    self._set_flag(i, FAILED_SUSPECT, r)
                elif self._calm_streak[i] >= cfg.clear_rounds:
                    self._set_flag(i, None, r)

        self._u_prev = np.where(act, u, np.nan)
        self._ewma_u = np.where(act, ew_u, np.nan)
        self._ewma_loss = np.where(act & np.isfinite(ew_l), ew_l, np.nan)
        self._prev_active = act

    # -- outputs -------------------------------------------------------------
    def verdicts(self) -> List[str]:
        """(capacity,) current per-slot verdicts."""
        return [f or HEALTHY for f in self._flag]

    def verdict(self, slot: int) -> str:
        return self._flag[slot] or HEALTHY

    @property
    def flagged(self) -> np.ndarray:
        """(capacity,) bool — slots currently carrying any flag."""
        return np.asarray([f is not None for f in self._flag])
