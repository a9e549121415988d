"""Failure scenario engine: pluggable fault / straggler models.

A copy of ``repro.core.scenarios`` (numpy only), so every scenario gives
the reference's masks for the same seed.

The paper models exactly one failure mode — i.i.d. Bernoulli suppression of
the worker↔master communication (``repro_torch.core.failure``). Real clusters fail
in richer ways: NICs flap (failures correlated in time), racks lose power
(failures correlated across workers), nodes run slow without dying
(stragglers — DaSGD, Zhou et al. 2020), and crashed workers rejoin from the
master checkpoint. Each regime stresses a different part of DEAHES-O's
dynamic weighting, so each gets its own generator here.

A :class:`FailureScenario` emits a :class:`ScenarioSchedule` — three
``(rounds, k)`` bool masks precomputed host-side with numpy (deterministic
given the seed). ``ElasticSession`` slices rows (or whole ``(R, k)``
blocks for jit-chunked execution) into the coordinator's ``RoundInputs``,
so every scenario is jit-compatible by construction:

``fail``
    communication with the master suppressed this round (the worker keeps
    training locally — network partition semantics, as in the paper).
``straggle``
    the worker is slow, not dead: it completes only a reduced effective τ in
    the local phase and scores itself against a stale master estimate
    (``ElasticConfig.straggler_tau_scale``).
``restart``
    the worker rejoins this round: its params are reset to the master
    before the local phase. Optimizer accumulators are restored, not
    re-initialized, and the u-history is deliberately *kept* — see
    ``ElasticTrainer.apply_restarts`` for both rationales (the score's
    recovery path, and the AdaHessian cold-start blow-up a fresh init
    causes).
``active``
    optional live-membership mask: which of the
    ``ElasticConfig.cap`` worker *slots* hold a live worker this round.
    ``None`` means every slot is live for the whole run (the fixed-k fast
    path). Unlike the three failure masks this stream is *planned*, not
    random — pools are resized by schedulers, not by coin flips — so the
    membership generators below are deterministic and seed-free. A slot
    that flips inactive→active is a **join**: the coordinator re-seats its
    params from the master (EASGD cold start). A slot that flips
    active→inactive is a **leave**: it simply freezes. The paper's §VI
    crash/restart experiments only ever suppress communication; live
    resize is a deliberate extension beyond §VI (see docs/paper_map.md).
``corrupt``
    optional byzantine mask: the worker's *gradients* are
    adversarially corrupted this round (sign-flip / scale / noise,
    ``ElasticConfig.byzantine_mode``), applied by the coordinator inside
    the jitted local phase. The worker still syncs — a poisoned node does
    not announce itself — which is exactly what stresses the h1/h2
    log-distance score. Disjoint from ``fail`` by construction (a corrupt
    round that also dropped comm would be invisible to the master and
    prove nothing). ``None`` = no corruption anywhere (the masking-free
    fast path; the jitted round specializes the branch away).
``speed``
    optional (rounds, k) float32 per-slot speed in (0, 1]: slot i completes
    ``max(1, round(speed * tau))`` local steps per round. Persistent
    heterogeneity (the ``hetero`` scenario repeats one row) as opposed to
    the transient ``straggle`` mask — a permanently slow node is a
    capacity fact, not a fault, so it does *not* stale the worker's score
    the way straggling does. ``None`` = homogeneous full-τ pool.

Scenario catalogue (names in ``repro_torch.configs.base.FAILURE_SCENARIOS``):

=============== ============================================================
``iid``         paper baseline: Bernoulli(``failure_prob``) per (round, worker)
``burst``       two-state Markov chain per worker (flapping NIC): failures
                arrive in bursts; stationary failure rate = ``failure_prob``
``correlated``  rack-level faults: workers are split into ``fault_groups``
                groups and a whole group fails together
``straggler``   no drops; Markov-persistent slow periods per worker at
                stationary rate ``failure_prob``
``crash_restart`` renewal process: a crash takes the worker down for
                ``crash_downtime`` rounds, then it rejoins reset to the
                master; stationary down-fraction = ``failure_prob``
``hetero``      no faults; persistent per-slot speeds drawn once from a
                lognormal or bimodal distribution (``hetero_*`` knobs)
``byzantine``   persistent corrupt-gradient slots (Bernoulli
                ``byzantine_frac`` per slot, ≥ 1 honest slot guaranteed);
                honest slots still fail iid at ``failure_prob``
=============== ============================================================

Trace replay (:class:`TraceScenario`, ``read_trace`` / ``write_trace``)
deliberately sits outside the catalogue: a recorded JSON-lines trace
carries its own rounds/capacity/channels and replays bit-identically,
ignoring the generator knobs. ``launch/train.py --dump-trace`` records any
live run (including controller-driven membership edits) and ``--trace``
replays it.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import (FAILURE_SCENARIOS, MEMBERSHIP_SCENARIOS,
                                      ElasticConfig)
from repro_torch.core.failure import failure_schedule_np


@dataclasses.dataclass(frozen=True)
class ScenarioSchedule:
    """Precomputed (rounds, k) bool masks (k = slot capacity);
    ``ElasticSession`` feeds rows (per-round) or contiguous blocks
    (``round_chunk``) into ``RoundInputs``. ``active`` is the optional
    live-membership stream — ``None`` keeps every slot live."""

    fail: np.ndarray
    straggle: np.ndarray
    restart: np.ndarray
    active: Optional[np.ndarray] = None
    corrupt: Optional[np.ndarray] = None
    speed: Optional[np.ndarray] = None

    def __post_init__(self):
        assert self.fail.shape == self.straggle.shape == self.restart.shape
        assert self.fail.dtype == bool
        if self.active is not None:
            assert self.active.shape == self.fail.shape
            assert self.active.dtype == bool
            assert self.active.any(axis=1).all(), \
                "every round needs at least one live worker"
        if self.corrupt is not None:
            assert self.corrupt.shape == self.fail.shape
            assert self.corrupt.dtype == bool
            assert not (self.corrupt & self.fail).any(), \
                "corrupt and fail masks must be disjoint: a corrupt round " \
                "that also drops comm never reaches the master"
        if self.speed is not None:
            assert self.speed.shape == self.fail.shape
            assert self.speed.dtype == np.float32, \
                f"speed must be float32, got {self.speed.dtype}"
            assert (self.speed > 0).all() and (self.speed <= 1).all(), \
                "speeds must be in (0, 1]"

    @property
    def rounds(self) -> int:
        return self.fail.shape[0]

    @property
    def num_workers(self) -> int:
        return self.fail.shape[1]

    @property
    def has_stragglers(self) -> bool:
        return bool(self.straggle.any())

    @property
    def has_restarts(self) -> bool:
        return bool(self.restart.any())

    @property
    def has_corruption(self) -> bool:
        """True when any (round, slot) cell is corrupt. An all-False
        ``corrupt`` array gates exactly like ``None``: the session never
        materializes the mask into ``RoundInputs``, so the jitted round
        keeps its corruption-free trace (no recompile, bitwise-identical
        masters — see tests/test_adversarial.py)."""
        return self.corrupt is not None and bool(self.corrupt.any())

    @property
    def has_hetero(self) -> bool:
        """True when any slot runs below full speed (a speed array of all
        ones gates like ``None``, same reasoning as ``has_corruption``)."""
        return self.speed is not None and bool((self.speed < 1.0).any())

    @property
    def has_membership(self) -> bool:
        return self.active is not None

    def with_membership(self, active: Optional[np.ndarray]
                        ) -> "ScenarioSchedule":
        """Attach a live-membership stream to this schedule (failure masks
        are kept verbatim; a failure drawn for a vacant slot is simply
        masked out by the coordinator)."""
        return dataclasses.replace(self, active=active)

    def joins(self) -> np.ndarray:
        """(rounds, k) bool — slot flips inactive→active at round r, i.e.
        the rounds where the coordinator must re-seat a joining slot from
        the master. Row 0 is all-False: the initial membership is seated by
        ``init_state``, not by a join event. All-False when ``active`` is
        ``None``."""
        if self.active is None:
            return np.zeros_like(self.fail)
        out = np.zeros_like(self.active)
        out[1:] = self.active[1:] & ~self.active[:-1]
        return out

    def leaves(self) -> np.ndarray:
        """(rounds, k) bool — slot flips active→inactive at round r (the
        worker left the pool before this round ran)."""
        if self.active is None:
            return np.zeros_like(self.fail)
        out = np.zeros_like(self.active)
        out[1:] = ~self.active[1:] & self.active[:-1]
        return out

    def blind(self) -> "ScenarioSchedule":
        """Detector-blind view: same shape/membership, all ground-truth
        event masks zeroed.

        ``RunSpec(detector_blind=True)`` echoes this view — not the real
        schedule — into every ``RoundRecord``, so nothing downstream of the
        session can read which slots truly failed, straggled, restarted or
        were corrupted; the truth still drives the run itself. ``active``
        is kept: live membership is the session's *own* output (the
        controller decided it), not an oracle input. ``speed`` is dropped
        entirely (replaced by ``None``) — a zeroed speed row would be an
        invalid schedule, and the ground-truth step rates are exactly what
        a blind detector must infer from ``round_ms``/``u`` telemetry.
        """
        z = np.zeros_like(self.fail)
        return dataclasses.replace(
            self, fail=z, straggle=z, restart=z,
            corrupt=None if self.corrupt is None else z, speed=None)

    def failed_recent(self, r: int) -> np.ndarray:
        """(k,) bool — the worker's sync was suppressed in the *previous*
        round (r−1; all-False at r=0).

        This is the canonical definition of "failed recently", the feed for
        the oracle baseline EAHES-OM which is allowed to read the schedule
        directly. Paper §VI frames the oracle as acting "as if we know when
        a node will fail": it snaps a worker back (h1=1) and shields the
        master (h2=0) on exactly the first successful sync after a missed
        one, then immediately restores normal α. A failed-within-
        ``score_window`` reading would keep suppressing up to
        ``score_window−1`` healthy syncs after a worker has already
        re-synced, which over-protects the master and is not what §VI
        describes. Every entrypoint receives this definition through
        ``ElasticSession``.
        """
        if r == 0:
            return np.zeros(self.num_workers, bool)
        return self.fail[r - 1]

    def failed_recent_all(self) -> np.ndarray:
        """(rounds, k) bool — ``failed_recent`` for every round (row r is
        ``fail[r−1]``, row 0 all-False). Precomputed form consumed by
        ``ElasticSession`` so chunked execution can slice (R, k) blocks
        straight into ``round_chunk``."""
        out = np.zeros_like(self.fail)
        out[1:] = self.fail[:-1]
        return out


def _zeros(rounds: int, k: int) -> np.ndarray:
    return np.zeros((rounds, k), bool)


def _check_rate(rate: float, name: str, lt_one: bool = False):
    hi_ok = rate < 1.0 if lt_one else rate <= 1.0
    if not (0.0 <= rate and hi_ok):
        bound = "[0, 1)" if lt_one else "[0, 1]"
        raise ValueError(f"{name}: rate must be in {bound}, got {rate}")


def _chain_enter_prob(rate: float, recover_prob: float, name: str) -> float:
    """Entry probability giving a two-state chain the stationary bad-rate
    ``rate``; validates that such a chain exists."""
    _check_rate(rate, name, lt_one=True)
    if not 0.0 < recover_prob <= 1.0:
        raise ValueError(f"{name}: recover_prob must be in (0, 1], "
                         f"got {recover_prob}")
    enter = recover_prob * rate / (1.0 - rate)
    if enter > 1.0:
        raise ValueError(
            f"{name}: no two-state chain has stationary rate {rate} with "
            f"recover_prob {recover_prob} (derived entry prob "
            f"{enter:.3f} > 1); lower one of them")
    return enter


def _markov_chain(rng: np.random.Generator, rounds: int, k: int,
                  p_enter: float, p_exit: float) -> np.ndarray:
    """(rounds, k) bool two-state chain per worker, True = 'bad' state.

    The chain starts from its stationary distribution
    π = p_enter / (p_enter + p_exit), so the marginal bad-rate is π at
    *every* round, not only asymptotically.
    """
    pi = p_enter / max(p_enter + p_exit, 1e-12)
    state = rng.random(k) < pi
    out = np.empty((rounds, k), bool)
    for t in range(rounds):
        out[t] = state
        u = rng.random(k)
        state = np.where(state, u < 1.0 - p_exit, u < p_enter)
    return out


@dataclasses.dataclass(frozen=True)
class FailureScenario:
    """Base class: emits (rounds, k) schedules, deterministic given seed."""

    name = "base"

    def schedule(self, seed: int, rounds: int, k: int) -> ScenarioSchedule:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IIDScenario(FailureScenario):
    """Paper §VI baseline: i.i.d. Bernoulli(rate) comm suppression."""

    rate: float = 1.0 / 3.0
    name = "iid"

    def __post_init__(self):
        _check_rate(self.rate, self.name)

    def schedule(self, seed, rounds, k):
        fail = failure_schedule_np(seed, rounds, k, self.rate)
        return ScenarioSchedule(fail, _zeros(rounds, k), _zeros(rounds, k))


@dataclasses.dataclass(frozen=True)
class _MarkovScenario(FailureScenario):
    """Shared two-state-chain machinery for ``burst`` and ``straggler``:
    ``recover_prob`` is P(bad→good) per round (mean bad period
    1/recover_prob rounds); the entry probability is derived so the
    stationary bad-rate equals ``rate``. Subclasses pick which schedule
    mask the chain fills."""

    rate: float = 1.0 / 3.0
    recover_prob: float = 0.25

    def __post_init__(self):
        self.enter_prob  # validates at construction

    @property
    def enter_prob(self) -> float:
        # stationarity: rate = enter / (enter + recover)
        return _chain_enter_prob(self.rate, self.recover_prob, self.name)

    def _chain(self, seed: int, rounds: int, k: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return _markov_chain(rng, rounds, k, self.enter_prob,
                             self.recover_prob)


@dataclasses.dataclass(frozen=True)
class BurstScenario(_MarkovScenario):
    """Time-correlated failures (flapping NIC): failures arrive in
    multi-round bursts."""

    name = "burst"

    def schedule(self, seed, rounds, k):
        return ScenarioSchedule(self._chain(seed, rounds, k),
                                _zeros(rounds, k), _zeros(rounds, k))


@dataclasses.dataclass(frozen=True)
class CorrelatedScenario(FailureScenario):
    """Rack-level faults: workers are split into ``groups`` contiguous
    groups; each group draws one Bernoulli(rate) per round and all its
    workers fail together."""

    rate: float = 1.0 / 3.0
    groups: int = 2
    name = "correlated"

    def __post_init__(self):
        _check_rate(self.rate, self.name)
        if self.groups < 1:
            raise ValueError(f"{self.name}: need ≥ 1 group, "
                             f"got {self.groups}")

    def group_of(self, k: int) -> np.ndarray:
        g = min(self.groups, k)
        return (np.arange(k) * g) // k

    def schedule(self, seed, rounds, k):
        rng = np.random.default_rng(seed)
        g = min(self.groups, k)
        group_fail = rng.random((rounds, g)) < self.rate
        fail = group_fail[:, self.group_of(k)]
        return ScenarioSchedule(fail, _zeros(rounds, k), _zeros(rounds, k))


@dataclasses.dataclass(frozen=True)
class StragglerScenario(_MarkovScenario):
    """Slow-not-dead workers (DaSGD regime): Markov-persistent slow periods
    at stationary rate ``rate``. No communication is dropped; a straggling
    worker runs a reduced effective τ and scores against a stale master."""

    name = "straggler"

    def schedule(self, seed, rounds, k):
        return ScenarioSchedule(_zeros(rounds, k),
                                self._chain(seed, rounds, k),
                                _zeros(rounds, k))


@dataclasses.dataclass(frozen=True)
class CrashRestartScenario(FailureScenario):
    """Crash + rejoin renewal process: an up worker crashes with a derived
    per-round probability, stays down (comm suppressed) for ``downtime``
    rounds, then rejoins with its state reset to the master (restart mask).
    The crash probability is chosen so the stationary fraction of down
    rounds equals ``rate``."""

    rate: float = 1.0 / 3.0
    downtime: int = 3
    name = "crash_restart"

    def __post_init__(self):
        if self.downtime < 1:
            raise ValueError(f"{self.name}: downtime must be ≥ 1 round, "
                             f"got {self.downtime}")
        _check_rate(self.rate, self.name, lt_one=True)
        if self.crash_prob > 1.0:
            d = self.downtime
            raise ValueError(
                f"{self.name}: rate {self.rate} unreachable with downtime "
                f"{d} — every cycle has ≥ 1 up round, capping the "
                f"down-fraction at {d / (d + 1):.3f}")

    @property
    def crash_prob(self) -> float:
        # renewal cycle: up-time of 1 + Geometric(c) rounds (the rejoin
        # round is crash-free, mean up-time 1/c) + `downtime` down rounds;
        # solve downtime / (downtime + 1/c) = rate for c.
        return self.rate / (self.downtime * (1.0 - self.rate))

    def schedule(self, seed, rounds, k):
        rng = np.random.default_rng(seed)
        d, c = self.downtime, self.crash_prob
        # near-stationary init: down with prob `rate`, residual downtime
        # uniform over 1..d
        remaining = np.where(rng.random(k) < self.rate,
                             rng.integers(1, d + 1, size=k), 0)
        down = np.empty((rounds, k), bool)
        just_up = np.zeros(k, bool)
        for t in range(rounds):
            # a worker never re-crashes on its rejoin round, so every outage
            # is followed by at least one up round where `restart` fires
            crash = (remaining == 0) & ~just_up & (rng.random(k) < c)
            remaining = np.where(crash, d, remaining)
            down[t] = remaining > 0
            just_up = remaining == 1
            remaining = np.maximum(remaining - 1, 0)
        restart = _zeros(rounds, k)
        restart[1:] = down[:-1] & ~down[1:]
        return ScenarioSchedule(down, _zeros(rounds, k), restart)


@dataclasses.dataclass(frozen=True)
class HeteroScenario(FailureScenario):
    """Persistent heterogeneous worker speeds: each slot draws
    one speed in (0, 1] at schedule time and keeps it for every round —
    the EASGD-analysis regime break where dynamic weighting should beat
    fixed-α hardest. No faults: a permanently slow node is a capacity
    fact, not a failure, so the ``fail``/``straggle`` channels stay empty
    and the score is *not* staled (unlike transient stragglers).

    ``lognormal``: speed = min(1, exp(sigma·z)), z ~ N(0,1) — about half
    the pool at full speed, the rest lognormally slower (heavier tail for
    larger sigma). ``bimodal``: a ``slow_frac`` fraction of slots runs at
    ``slow_scale``, the rest at full speed (two hardware generations).
    """

    dist: str = "lognormal"
    sigma: float = 0.6
    slow_frac: float = 0.25
    slow_scale: float = 0.25
    name = "hetero"

    def __post_init__(self):
        if self.dist not in ("lognormal", "bimodal"):
            raise ValueError(f"{self.name}: dist must be 'lognormal' or "
                             f"'bimodal', got {self.dist!r}")
        if self.sigma <= 0:
            raise ValueError(f"{self.name}: sigma must be > 0, "
                             f"got {self.sigma}")
        _check_rate(self.slow_frac, self.name)
        if not 0.0 < self.slow_scale <= 1.0:
            raise ValueError(f"{self.name}: slow_scale must be in (0, 1], "
                             f"got {self.slow_scale}")

    def slot_speeds(self, seed: int, k: int) -> np.ndarray:
        """(k,) float32 persistent speeds — the single row every round
        repeats."""
        rng = np.random.default_rng(seed)
        if self.dist == "lognormal":
            s = np.minimum(1.0, np.exp(self.sigma * rng.standard_normal(k)))
        else:
            s = np.where(rng.random(k) < self.slow_frac,
                         self.slow_scale, 1.0)
        return s.astype(np.float32)

    def schedule(self, seed, rounds, k):
        speed = np.tile(self.slot_speeds(seed, k), (rounds, 1))
        return ScenarioSchedule(_zeros(rounds, k), _zeros(rounds, k),
                                _zeros(rounds, k), speed=speed)


@dataclasses.dataclass(frozen=True)
class ByzantineScenario(FailureScenario):
    """Persistent corrupt-gradient slots: each slot is byzantine
    with probability ``frac`` for the whole run (compromised nodes do not
    heal), with at least one honest slot guaranteed. Honest slots still
    suffer iid comm failures at ``fail_rate`` — the paper's §VI noise
    floor — drawn on honest slots only, so ``corrupt`` and ``fail`` are
    disjoint by construction (a corrupt round that also dropped comm never
    reaches the master and would prove nothing about the weighting)."""

    frac: float = 0.25
    fail_rate: float = 1.0 / 3.0
    name = "byzantine"

    def __post_init__(self):
        _check_rate(self.frac, f"{self.name}.frac", lt_one=True)
        _check_rate(self.fail_rate, f"{self.name}.fail_rate")

    def corrupt_slots(self, seed: int, k: int) -> np.ndarray:
        """(k,) bool persistent byzantine assignment (the row every round
        repeats). Deterministic given seed; slot 0 is force-cleared in the
        measure-zero draw where every slot came up corrupt."""
        rng = np.random.default_rng(seed)
        bad = rng.random(k) < self.frac
        if bad.all():
            bad[0] = False
        return bad

    def schedule(self, seed, rounds, k):
        rng = np.random.default_rng(seed)
        bad = rng.random(k) < self.frac      # same draw as corrupt_slots
        if bad.all():
            bad[0] = False
        corrupt = np.tile(bad, (rounds, 1))
        fail = (rng.random((rounds, k)) < self.fail_rate) & ~corrupt
        return ScenarioSchedule(fail, _zeros(rounds, k), _zeros(rounds, k),
                                corrupt=corrupt)


# ---------------------------------------------------------------------------
# trace replay: record / replay ScenarioSchedules as JSON lines
# ---------------------------------------------------------------------------

TRACE_KIND = "scenario-trace"
TRACE_VERSION = 1


def trace_membership_steps(sched: ScenarioSchedule
                           ) -> Tuple[Tuple[int, int], ...]:
    """The (round, k) resize steps equivalent to ``sched.active``, in the
    exact vocabulary ``parse_membership_plan`` accepts — so
    ``",".join(f"{r}:{k}" for r, k in steps)`` round-trips through the CLI
    plan parser and ``PlanMembership``. Only defined when every active row
    is a prefix mask (the lowest-n slots live, which is what every
    membership generator and ``ElasticSession.apply`` emit); raises
    ``ValueError`` for non-prefix masks, which a trace records as explicit
    ``active`` slot lists instead."""
    if sched.active is None:
        return ()
    counts = sched.active.sum(axis=1)
    if not (sched.active == _active_rows(sched.rounds, sched.num_workers,
                                         counts)).all():
        raise ValueError(
            "membership stream has non-prefix active rows; no "
            "parse_membership_plan-compatible step list exists")
    steps = [(0, int(counts[0]))]
    for r in range(1, sched.rounds):
        if counts[r] != counts[r - 1]:
            steps.append((int(r), int(counts[r])))
    return tuple(steps)


def trace_lines(sched: ScenarioSchedule) -> List[str]:
    """Serialize a schedule as JSON lines: one header line (kind, version,
    rounds, capacity, optional channels present), then one event line per
    True mask cell / value change. Replays bit-identically through
    ``parse_trace`` — including the exact ``None``-ness of the optional
    channels, which gates jit specialization downstream.

    Membership events use the same ``(round, k)`` vocabulary as
    ``parse_membership_plan`` (``{"ch": "k", "k": n}`` = resize to the
    lowest n slots) whenever the active rows are prefix masks, falling
    back to explicit ``{"ch": "active", "slots": [...]}`` rows otherwise.
    """
    header = {"kind": TRACE_KIND, "version": TRACE_VERSION,
              "rounds": sched.rounds, "capacity": sched.num_workers}
    channels = [ch for ch in ("active", "corrupt", "speed")
                if getattr(sched, ch) is not None]
    if channels:
        header["channels"] = channels
    lines = [json.dumps(header)]
    for ch in ("fail", "straggle", "restart", "corrupt"):
        arr = getattr(sched, ch)
        if arr is None:
            continue
        for r, i in zip(*np.nonzero(arr)):
            lines.append(json.dumps(
                {"round": int(r), "slot": int(i), "ch": ch}))
    if sched.speed is not None:
        for i in range(sched.num_workers):
            col = sched.speed[:, i]
            for r in range(sched.rounds):
                if r == 0 or col[r] != col[r - 1]:
                    # float32 -> python float (f64) -> float32 is exact
                    lines.append(json.dumps(
                        {"round": r, "slot": i, "ch": "speed",
                         "v": float(col[r])}))
    if sched.active is not None:
        try:
            steps = trace_membership_steps(sched)
            for r, k in steps:
                lines.append(json.dumps({"round": r, "ch": "k", "k": k}))
        except ValueError:
            prev = None
            for r in range(sched.rounds):
                row = sched.active[r]
                if prev is None or (row != prev).any():
                    lines.append(json.dumps(
                        {"round": r, "ch": "active",
                         "slots": [int(s) for s in np.nonzero(row)[0]]}))
                prev = row
    return lines


def parse_trace(lines: Sequence[str]) -> ScenarioSchedule:
    """Inverse of ``trace_lines``: rebuild the exact ScenarioSchedule
    (bit-identical masks, same optional-channel ``None``-ness). Events are
    applied in round order; ``speed``/``k``/``active`` events fill forward
    from their round until the next event for that slot/stream."""
    body = [ln for ln in lines if ln.strip()]
    if not body:
        raise ValueError("empty trace")
    header = json.loads(body[0])
    if header.get("kind") != TRACE_KIND:
        raise ValueError(f"not a scenario trace: kind={header.get('kind')!r}")
    if header.get("version") != TRACE_VERSION:
        raise ValueError(f"unsupported trace version {header.get('version')!r}"
                         f" (this reader is v{TRACE_VERSION})")
    rounds, k = int(header["rounds"]), int(header["capacity"])
    channels = set(header.get("channels", ()))
    unknown = channels - {"active", "corrupt", "speed"}
    if unknown:
        raise ValueError(f"unknown trace channels {sorted(unknown)}")
    masks = {ch: _zeros(rounds, k) for ch in ("fail", "straggle", "restart")}
    corrupt = _zeros(rounds, k) if "corrupt" in channels else None
    speed = np.ones((rounds, k), np.float32) if "speed" in channels else None
    active = np.ones((rounds, k), bool) if "active" in channels else None
    events = [json.loads(ln) for ln in body[1:]]
    events.sort(key=lambda e: e["round"])  # stable: file order within a round
    for ev in events:
        r, ch = int(ev["round"]), ev["ch"]
        if not 0 <= r < rounds:
            raise ValueError(f"trace event round {r} outside 0..{rounds-1}")
        if ch in masks or ch == "corrupt":
            i = int(ev["slot"])
            if not 0 <= i < k:
                raise ValueError(f"trace event slot {i} outside 0..{k-1}")
            if ch == "corrupt":
                if corrupt is None:
                    raise ValueError(
                        "corrupt event but 'corrupt' not in header channels")
                corrupt[r, i] = True
            else:
                masks[ch][r, i] = True
        elif ch == "speed":
            if speed is None:
                raise ValueError(
                    "speed event but 'speed' not in header channels")
            speed[r:, int(ev["slot"])] = np.float32(ev["v"])
        elif ch == "k":
            if active is None:
                raise ValueError(
                    "membership event but 'active' not in header channels")
            active[r:] = np.arange(k) < int(ev["k"])
        elif ch == "active":
            if active is None:
                raise ValueError(
                    "membership event but 'active' not in header channels")
            row = np.zeros(k, bool)
            row[[int(s) for s in ev["slots"]]] = True
            active[r:] = row
        else:
            raise ValueError(f"unknown trace event channel {ch!r}")
    return ScenarioSchedule(masks["fail"], masks["straggle"],
                            masks["restart"], active=active,
                            corrupt=corrupt, speed=speed)


def write_trace(path, sched: ScenarioSchedule) -> None:
    Path(path).write_text("\n".join(trace_lines(sched)) + "\n")


def read_trace(path) -> ScenarioSchedule:
    return parse_trace(Path(path).read_text().splitlines())


@dataclasses.dataclass(frozen=True)
class TraceScenario(FailureScenario):
    """Replay a recorded trace (``launch/train.py --dump-trace`` writes
    one from any live run, controller-driven membership edits included).
    The trace carries its own rounds/capacity, so ``schedule`` validates
    the requested shape against it and ignores the seed — replay is
    deterministic by construction. Deliberately not in
    ``FAILURE_SCENARIOS`` (it has no generator knobs); sessions attach it
    via ``RunSpec.schedule`` (CLI: ``--trace``)."""

    path: str = ""
    name = "trace"

    def schedule(self, seed, rounds, k):
        sched = read_trace(self.path)
        if rounds != sched.rounds or k != sched.num_workers:
            raise ValueError(
                f"trace {self.path!r} was recorded for "
                f"(rounds={sched.rounds}, capacity={sched.num_workers}); "
                f"requested (rounds={rounds}, capacity={k}) — replay runs "
                f"must match the recorded shape")
        return sched


# ---------------------------------------------------------------------------
# membership scenarios: planned worker-pool resize streams
# ---------------------------------------------------------------------------

def _active_rows(rounds: int, capacity: int, counts: np.ndarray
                 ) -> np.ndarray:
    """(rounds, capacity) mask with ``counts[r]`` live slots at round r,
    always the lowest-numbered slots (resize keeps surviving workers in
    place: growing activates the lowest vacant slots, shrinking retires
    the highest live ones)."""
    return np.arange(capacity)[None, :] < np.asarray(counts)[:, None]


@dataclasses.dataclass(frozen=True)
class MembershipScenario:
    """Base class: emits a (rounds, capacity) live-slot mask, deterministic
    and seed-free (membership events are planned by a scheduler, unlike
    the random failure streams)."""

    name = "static"

    def active_schedule(self, rounds: int, capacity: int, k0: int
                        ) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StaticMembership(MembershipScenario):
    """No membership events: the initial ``k0`` slots stay live. With
    ``capacity > k0`` this is the capacity-padded steady state the
    ``--what membership`` benchmark measures."""

    name = "static"

    def active_schedule(self, rounds, capacity, k0):
        return _active_rows(rounds, capacity,
                            np.full(rounds, k0, np.int64))


def _resolve_round(at: int, rounds: int) -> int:
    r = at or rounds // 2
    if not 0 < r < rounds:
        raise ValueError(
            f"membership_round={r} must fall inside the run (1..{rounds-1})")
    return r


@dataclasses.dataclass(frozen=True)
class ScaleUpMembership(MembershipScenario):
    """The pool grows once: k0 → ``k_to`` live workers at round ``at``
    (defaults: every slot, mid-run). Joining slots cold-start from the
    master — the EASGD round-robin loop's natural admission."""

    k_to: int = 0
    at: int = 0
    name = "scale_up"

    def active_schedule(self, rounds, capacity, k0):
        k_to, at = self.k_to or capacity, _resolve_round(self.at, rounds)
        if not k0 < k_to <= capacity:
            raise ValueError(
                f"scale_up: need k0 < k_to <= capacity, got "
                f"{k0} -> {k_to} at capacity {capacity}")
        counts = np.where(np.arange(rounds) < at, k0, k_to)
        return _active_rows(rounds, capacity, counts)


@dataclasses.dataclass(frozen=True)
class ScaleDownMembership(MembershipScenario):
    """The pool shrinks once: k0 → ``k_to`` at round ``at`` (defaults:
    half the pool, mid-run). Retired slots freeze; their data shards are
    re-partitioned over the survivors."""

    k_to: int = 0
    at: int = 0
    name = "scale_down"

    def active_schedule(self, rounds, capacity, k0):
        k_to, at = self.k_to or max(1, k0 // 2), _resolve_round(self.at,
                                                                rounds)
        if not 1 <= k_to < k0:
            raise ValueError(
                f"scale_down: need 1 <= k_to < k0, got {k0} -> {k_to}")
        counts = np.where(np.arange(rounds) < at, k0, k_to)
        return _active_rows(rounds, capacity, counts)


@dataclasses.dataclass(frozen=True)
class PreemptRejoinMembership(MembershipScenario):
    """Spot-instance preemption: the highest ``n`` live slots leave the
    pool at round ``at`` and rejoin ``downtime`` rounds later (cold-started
    from the master on rejoin). Unlike ``crash_restart`` the slots are
    *vacant* while gone — no local training, no scoring — which is what
    actually happens when the instance is reclaimed."""

    n: int = 1
    at: int = 0
    downtime: int = 3
    name = "preempt_rejoin"

    def active_schedule(self, rounds, capacity, k0):
        at = _resolve_round(self.at, rounds)
        if not 1 <= self.n < k0:
            raise ValueError(
                f"preempt_rejoin: need 1 <= n < k0, got n={self.n}, "
                f"k0={k0}")
        if self.downtime < 1:
            raise ValueError("preempt_rejoin: downtime must be >= 1")
        down = (np.arange(rounds) >= at) & (np.arange(rounds)
                                            < at + self.downtime)
        counts = np.where(down, k0 - self.n, k0)
        return _active_rows(rounds, capacity, counts)


@dataclasses.dataclass(frozen=True)
class PlanMembership(MembershipScenario):
    """Explicit resize plan: ``steps`` is a sorted tuple of (round, k)
    events; the pool runs at k0 until the first step, then at each step's
    k until the next. The CI membership smoke drives 4→2→6 through this."""

    steps: Tuple[Tuple[int, int], ...] = ()
    name = "plan"

    def active_schedule(self, rounds, capacity, k0):
        counts = np.full(rounds, k0, np.int64)
        for r, k in sorted(self.steps):
            if not 1 <= k <= capacity:
                raise ValueError(
                    f"membership plan step ({r}, {k}): k outside "
                    f"1..{capacity}")
            if r < rounds:
                counts[r:] = k
        return _active_rows(rounds, capacity, counts)


def parse_membership_plan(text: str) -> Tuple[Tuple[int, int], ...]:
    """CLI form of a resize plan: ``"round:k,round:k,..."`` (e.g.
    ``"2:2,4:6"`` = shrink to 2 workers at round 2, grow to 6 at 4)."""
    steps = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            r, k = part.split(":")
            steps.append((int(r), int(k)))
        except ValueError:
            raise ValueError(
                f"membership plan step {part!r}: expected 'round:k'")
    return tuple(steps)


def make_membership(ecfg: ElasticConfig) -> MembershipScenario:
    """Build the membership scenario named by ``ecfg.membership_scenario``
    from the ElasticConfig knobs (``membership_k``, ``membership_round``,
    ``membership_plan``; preempt downtime reuses ``crash_downtime``)."""
    name = ecfg.membership_scenario
    if name == "static":
        return StaticMembership()
    if name == "scale_up":
        return ScaleUpMembership(ecfg.membership_k, ecfg.membership_round)
    if name == "scale_down":
        return ScaleDownMembership(ecfg.membership_k, ecfg.membership_round)
    if name == "preempt_rejoin":
        return PreemptRejoinMembership(ecfg.membership_k or 1,
                                       ecfg.membership_round,
                                       ecfg.crash_downtime)
    if name == "plan":
        return PlanMembership(ecfg.membership_plan)
    raise ValueError(f"unknown membership scenario {name!r}; "
                     f"known: {MEMBERSHIP_SCENARIOS}")


def make_scenario(ecfg: ElasticConfig) -> FailureScenario:
    """Build the scenario named by ``ecfg.failure_scenario`` from the
    ElasticConfig knobs (rate = ``failure_prob`` for every scenario)."""
    name, p = ecfg.failure_scenario, ecfg.failure_prob
    if name == "iid":
        return IIDScenario(p)
    if name == "burst":
        return BurstScenario(p, ecfg.burst_recover_prob)
    if name == "correlated":
        return CorrelatedScenario(p, ecfg.fault_groups)
    if name == "straggler":
        return StragglerScenario(p, ecfg.burst_recover_prob)
    if name == "crash_restart":
        return CrashRestartScenario(p, ecfg.crash_downtime)
    if name == "hetero":
        return HeteroScenario(ecfg.hetero_dist, ecfg.hetero_sigma,
                              ecfg.hetero_slow_frac, ecfg.hetero_slow_scale)
    if name == "byzantine":
        return ByzantineScenario(ecfg.byzantine_frac, p)
    raise ValueError(f"unknown failure scenario {name!r}; "
                     f"known: {FAILURE_SCENARIOS}")


def scenario_names() -> tuple:
    return FAILURE_SCENARIOS
