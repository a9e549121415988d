"""`RunSpec` → `ElasticSession`: the run loop of the port's elastic trainer.

Mirrors ``repro.api.session`` for the paper's CNN and the dense LMs
(qwen3-4b, stablelm-3b, h2o-danube-1.8b) under an open-loop failure
scenario. ``RunSpec`` replaces the reference's ``use_pallas`` with
``device`` (default ``"cuda"``): on the card every kernel of the round runs
as a hand-written CUDA kernel, on ``device="cpu"`` as its plain PyTorch
version. A ``"cuda"`` run on a machine without a card raises.

Execution is a Python loop over rounds. ``rounds_per_call`` groups rounds
into chunks that read their metrics back to the host once (there is no jit
to amortise, so chunked and per-round runs compute the same numbers);
chunk boundaries still snap to eval rounds. ``RoundRecord.round_ms`` is the
chunk's wall time per round, closed by ``torch.cuda.synchronize()`` on the
card; ``dispatch_ms`` is the time until the host had queued the chunk.

``RunSpec.plain`` is the single-worker control (the k=1 limit: no elastic
sync, no failures, one "round" is one optimizer step through
``repro_torch.train.steps``). ``save``/``restore`` write and read the
master in the reference's checkpoint format (``repro_torch.checkpoint``);
``RunSpec.save_path`` saves at the end of the run. The adversarial
``corrupt``/``speed`` channels of the byzantine and hetero scenarios ride
into every round.

Elastic membership: with ``ElasticConfig.capacity > num_workers`` (or any
non-static ``membership_scenario``) the worker axis is capacity-padded and
a per-round live mask (``make_membership``'s stream, or a custom
schedule's ``active`` rows) rides through ``RoundInputs``. Chunks snap to
membership transitions, so the data is re-partitioned over the new pool
between chunks; joining slots are re-seated from the master; every
:class:`RoundRecord` echoes the live mask. ``restore`` may warm-start at
another capacity.

Closed-loop control: ``apply(ControlAction)`` is the one live-control
entry point (``resize`` / ``set_membership`` are deprecated wrappers).
Observers (``add_observer``, or ``RunSpec.controller="rules"`` for the
rule controller of ``repro_torch.control``) see every record
(``on_round``) and get the mutation window between chunks
(``on_chunk_end``). ``RunSpec.detector_blind`` echoes a mask-zeroed
schedule into the records, so a controller runs on observable telemetry
only.

Hierarchical averaging (``ElasticConfig.groups`` / ``global_period``,
fused comm): every :class:`RoundRecord` carries the racks' (G,) ``g_u``,
``g_score``, ``g_h1``, ``g_h2`` (zero off the global-sync rounds);
``save`` writes the sub-masters as a sibling ``submasters`` checkpoint
before the main manifest, and ``restore`` re-seats them and the racks'
u-histories, also at another rack count.

Sharded placement (``ElasticConfig.placement = "sharded"``): the slot
axis is split over the ranks of a ``torch.distributed`` process group
(``group``, else the default group, else world size 1; see
``repro_torch.core.coordinator``). The capacity is padded to a multiple of
the world size, the padded slots vacant (as any slot above the live
pool, a resize may fill them); each rank uploads only
its rows of the batches; the master, the records and eval are replicated,
so membership, ``apply`` and the rule controller decide the same on every
rank (``round_ms`` is the slowest rank's). ``save`` writes from rank 0
only, in the same format; ``restore`` re-seats on every rank, from a
checkpoint of any placement and world size.

LM training (an LM ``arch`` or ``model_cfg``): the workers read
``SyntheticTokens`` through the overlap ``TokenWorkerBatcher``
(``seq_len``, ``n_tokens``), the master is evaluated on a held-out batch
drawn from the same stream with ``seed + 31``, and ``evaluate`` returns
``(loss, None)`` (an LM has no accuracy). The workers and the master are
float32 flat buffers whatever the config's ``param_dtype``; the model
computes in its activation dtype. Under the trainer's ``vmap(jvp(grad))``
attention takes the reference's training path (``nn/layers.py``); the
held-out eval runs under ``no_grad``, through the flash kernel at its
shapes. A VLM (qwen2-vl-7b) trains text-only, as the reference's
session feeds it tokens only; an encoder-decoder session raises by name
at construction (it needs ``src`` frames, and the reference's fails); the
other LM families raise by name (``repro_torch.models.registry``).
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.configs.base import (ElasticConfig, ModelConfig,
                                      OptimizerConfig, get_config)
from repro_torch.control.actions import ControlAction, SessionObserver
from repro_torch.control.actuator import make_controller
from repro_torch.core.coordinator import (ElasticTrainer, NoiseFn, ProbeFn,
                                          RoundInputs)
from repro_torch.core.scenarios import (ScenarioSchedule, make_membership,
                                        make_scenario)
from repro_torch.data.pipeline import TokenWorkerBatcher, WorkerBatcher
from repro_torch.data.synthetic import SyntheticImages, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (max_over_ranks, padded_capacity,
                                     world_and_rank)
from repro_torch.models.registry import build_model
from repro_torch.nn.param import tree_from_leaves
from repro_torch.train.steps import init_train_state, make_train_step


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything a run needs, validated at construction (fields as in
    ``repro.api.session.RunSpec``; ``device`` replaces ``use_pallas``).
    ``data_seed`` seeds dataset generation, ``seed`` the init, batching
    and probes, ``scenario_seed`` (default ``seed + 7``) the schedule."""

    arch: str = "paper-cnn"
    smoke: bool = False
    model_cfg: Optional[ModelConfig] = None
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    elastic: ElasticConfig = dataclasses.field(default_factory=ElasticConfig)
    rounds: int = 20
    rounds_per_call: int = 1
    seed: int = 0
    scenario_seed: Optional[int] = None
    schedule: Optional[ScenarioSchedule] = None
    plain: bool = False
    batch_size: int = 32
    seq_len: int = 128
    n_data: int = 8000
    n_test: int = 1000
    n_tokens: int = 100_000
    data_seed: int = 0
    eval_every: int = 0  # 0 = never; >0 = every e rounds + the final round
    save_path: Optional[str] = None
    device: str = "cuda"
    controller: Optional[str] = None  # None = open loop; "rules"
    detector_blind: bool = False  # echo mask-zeroed schedule into records
    # workers per vmapped local-phase call (None: all at once; see
    # ElasticTrainer.worker_chunk): bounds an LM's activation memory
    worker_chunk: Optional[int] = None

    def __post_init__(self):
        for name in ("rounds", "rounds_per_call", "batch_size", "seq_len",
                     "n_data", "n_test", "n_tokens"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"RunSpec.{name} must be >= 1, got {v}")
        if self.eval_every < 0:
            raise ValueError(
                f"RunSpec.eval_every must be >= 0, got {self.eval_every}")
        if self.worker_chunk is not None and self.worker_chunk < 1:
            raise ValueError(f"RunSpec.worker_chunk must be None or >= 1, "
                             f"got {self.worker_chunk}")
        if self.schedule is not None:
            if self.plain:
                raise ValueError(
                    "RunSpec: plain mode has no failure schedule")
            want = (self.rounds, self.elastic.cap)
            if self.schedule.fail.shape != want:
                raise ValueError(
                    f"RunSpec.schedule shape {self.schedule.fail.shape} != "
                    f"(rounds, capacity) = {want}")
        if self.controller is not None:
            if self.controller != "rules":
                raise ValueError(
                    f"RunSpec.controller must be None or 'rules', got "
                    f"{self.controller!r}")
            if self.plain:
                raise ValueError(
                    "RunSpec: plain mode has no worker pool to control")
        if self.detector_blind and self.elastic.oracle:
            raise ValueError(
                "RunSpec: detector_blind contradicts ElasticConfig.oracle — "
                "the oracle weighting itself reads the ground-truth masks")

    def replace(self, **kw) -> "RunSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One communication round, on the host (fields as in the reference:
    (cap,) ``u/score/h1/h2/loss_w``, the schedule rows that drove the
    round — all-False under ``RunSpec.detector_blind`` — the live mask
    ``active``, eval metrics on eval rounds, and the chunk's timings).
    Vacant slots report zeroed diagnostics. In plain mode the diagnostics
    are (1,) zeros and ``loss_w`` is None. A hierarchical run adds the
    racks' (G,) ``g_u/g_score/g_h1/g_h2``, zero on rounds without a global
    sync and for a fully vacant rack; ``None`` on flat runs."""

    round: int
    loss: float
    u: np.ndarray
    score: np.ndarray
    h1: np.ndarray
    h2: np.ndarray
    fail: np.ndarray
    straggle: np.ndarray
    restart: np.ndarray
    eval_loss: Optional[float] = None
    eval_acc: Optional[float] = None
    active: Optional[np.ndarray] = None
    loss_w: Optional[np.ndarray] = None
    round_ms: float = 0.0
    dispatch_ms: float = 0.0
    # (k,) bool byzantine slots of the round (all False without them)
    corrupt: Optional[np.ndarray] = None
    # (G,) rack diagnostics of a hierarchical run
    g_u: Optional[np.ndarray] = None
    g_score: Optional[np.ndarray] = None
    g_h1: Optional[np.ndarray] = None
    g_h2: Optional[np.ndarray] = None

    @property
    def num_active(self) -> int:
        return int(self.active.sum()) if self.active is not None else 0


class ElasticSession:
    """Stateful runner for one run: trainer state + schedule + batcher + eval.

    ``params`` (optional, a nested tree of arrays in the reference layout)
    seats every worker and the master (or the single worker of plain
    mode), e.g. the reference's own init carried across; ``probe_fn`` and
    ``noise_fn`` replace the probe and byzantine-noise draws (see
    ``ElasticTrainer.probe_fn``; plain mode calls ``probe_fn(step, 0, 0)``).
    ``run_iter()`` yields a :class:`RoundRecord` per round; ``run()``
    collects them. ``group`` is the process group of a sharded run (None:
    the default group, if one is initialised).
    """

    def __init__(self, spec: RunSpec, *, params=None,
                 probe_fn: Optional[ProbeFn] = None,
                 noise_fn: Optional[NoiseFn] = None, group=None):
        self.spec = spec
        self.device = resolve_device(spec.device)
        cfg = spec.model_cfg or get_config(spec.arch, smoke=spec.smoke)
        self.model_cfg = cfg
        if cfg.family == "encdec":
            raise NotImplementedError(
                f"{cfg.name}: an encoder-decoder trains on source frames "
                "'src' beside its tokens, and the session's LM data feeds "
                "tokens only (the reference's session fails there too)")
        self.model = build_model(cfg)
        ecfg = spec.elastic
        if spec.plain:
            # the k=1 limit: one worker, no exchange, no failures
            ecfg = dataclasses.replace(
                ecfg, num_workers=1, capacity=0, tau=1, overlap_ratio=0.0,
                failure_prob=0.0, placement="single",
                membership_scenario="static", groups=1, global_period=1)
        self._sharded = ecfg.placement == "sharded"
        self._group = group
        self._world = world_and_rank(group)[0] if self._sharded else 1
        cap = padded_capacity(ecfg.cap, self._world)
        if cap != ecfg.cap:
            if spec.schedule is not None:
                raise ValueError(
                    f"RunSpec.schedule covers {ecfg.cap} slots, which do not "
                    f"split over {self._world} ranks: pad the schedule")
            # the padded slots start vacant: capacity > num_workers seats
            # a membership stream whose live slots come first
            ecfg = dataclasses.replace(ecfg, capacity=cap)
        self.ecfg = ecfg
        self.capacity = ecfg.cap
        self.trainer = ElasticTrainer(self.model, spec.optimizer, ecfg,
                                      device=self.device, probe_fn=probe_fn,
                                      noise_fn=noise_fn, seed=spec.seed,
                                      group=group,
                                      worker_chunk=spec.worker_chunk)
        self._rows = slice(self.trainer._lo, self.trainer._hi)
        self.layout = self.trainer.layout
        # -- data -----------------------------------------------------------
        if cfg.family == "cnn":
            ds = SyntheticImages(n=spec.n_data, n_test=spec.n_test,
                                 seed=spec.data_seed)
            self.batcher = WorkerBatcher(ds.images, ds.labels, ecfg,
                                         batch_size=spec.batch_size,
                                         seed=spec.seed)
            test = ds.test_batch()
        else:
            toks = SyntheticTokens(vocab=cfg.vocab_size,
                                   n_tokens=spec.n_tokens,
                                   seed=spec.data_seed)
            self.batcher = TokenWorkerBatcher(toks.tokens, ecfg,
                                              batch_size=spec.batch_size,
                                              seq_len=spec.seq_len,
                                              seed=spec.seed)
            # held-out eval batch from the same stream, disjoint rng
            test = toks.batch(np.random.default_rng(spec.seed + 31),
                              spec.batch_size, spec.seq_len)
        self._test = self._to_device(test)
        self.round = 0  # rounds completed so far
        self._active = np.arange(self.capacity) < ecfg.num_workers
        self._observers: List[SessionObserver] = []
        self.controller = None
        if spec.plain:
            self.schedule = None
            self._membership = self._join_rows = None
            self.state = init_train_state(self.model, spec.optimizer, params,
                                          seed=spec.seed, device=self.device)
            self._step = make_train_step(
                self.model, spec.optimizer, probe_fn=self.trainer.probe_fn,
                device=self.device)
            return
        # -- schedule -------------------------------------------------------
        if spec.schedule is not None:
            self.schedule = spec.schedule
        else:
            sseed = (spec.scenario_seed if spec.scenario_seed is not None
                     else spec.seed + 7)
            self.schedule = make_scenario(ecfg).schedule(
                sseed, spec.rounds, self.capacity)
        if self.schedule.active is None and (
                self.capacity > ecfg.num_workers
                or ecfg.membership_scenario != "static"):
            # membership stream: planned resize events at capacity
            self.schedule = self.schedule.with_membership(
                make_membership(ecfg).active_schedule(
                    spec.rounds, self.capacity, ecfg.num_workers))
        self._failed_recent = self.schedule.failed_recent_all()
        self._refresh_membership()
        # -- observers / controller -----------------------------------------
        # detector-blind runs echo a mask-zeroed schedule view into the
        # records; the real schedule still drives RoundInputs
        self._echo = (self.schedule.blind() if spec.detector_blind
                      else self.schedule)
        if spec.controller is not None:
            self.controller = make_controller(spec.controller, self.capacity)
            self.add_observer(self.controller)
        self.state = self.trainer.init_state(params)
        if self.schedule.has_membership:
            # seat round 0's membership (a custom schedule or a plan step
            # at round 0 may start with another pool than num_workers)
            self._apply_membership(self.schedule.active[0])

    def _to_device(self, batch):
        """Host numpy batch → tensors on the run's device; integer
        entries (labels, tokens, targets) as int64."""
        return {key: torch.as_tensor(val).to(
                    self.device, torch.int64
                    if np.issubdtype(val.dtype, np.integer) else None)
                for key, val in batch.items()}

    # -- eval ---------------------------------------------------------------
    @property
    def master_params(self) -> torch.Tensor:
        """The authoritative flat (n,) parameters: the elastic master, or
        the single worker's params in plain mode."""
        return (self.state["params"] if self.spec.plain
                else self.state["master"])

    def master_tree(self):
        """:attr:`master_params` as a nested tree of views in the
        reference layout."""
        flat = self.master_params
        return tree_from_leaves(
            (leaf.path, flat[leaf.offset:leaf.offset + leaf.size]
             .view(leaf.shape)) for leaf in self.layout.leaves)

    @torch.no_grad()
    def evaluate(self):
        """(held-out loss, accuracy-or-None) of the master params: an LM
        has no accuracy."""
        params = self.layout.views(self.master_params)
        acc = getattr(self.model, "accuracy", None)
        return (float(self.model.loss(params, self._test)[0]),
                None if acc is None else float(acc(params, self._test)))

    def _is_eval_round(self, r: int) -> bool:
        e = self.spec.eval_every
        return e > 0 and (r % e == 0 or r == self.spec.rounds - 1)

    # -- checkpoint ---------------------------------------------------------
    def save(self, path: Optional[str] = None,
             extra_metadata: Optional[dict] = None) -> str:
        """Save the master params with the reference's metadata:
        ``{"rounds", "arch", "scenario"}``, plus, for an elastic run, the
        per-slot manifest (capacity, active mask, u-history; a hierarchy
        adds its rack count, global period and rack u-histories) that
        :meth:`restore` re-seats. A hierarchy's sub-masters go to the
        sibling checkpoint ``<path>/submasters`` (a param tree with a
        leading (G,) axis), written before the main manifest so that the
        manifest, written last, implies both; the main tree stays the bare
        master. A sharded run's ranks all call this; rank 0 writes."""
        path = path or self.spec.save_path
        if not path:
            raise ValueError("no save path: pass one or set RunSpec.save_path")
        meta = {"rounds": self.round, "arch": self.model_cfg.name,
                "scenario": ("none" if self.spec.plain
                             else self.ecfg.failure_scenario)}
        hier = not self.spec.plain and self.trainer._hier
        if not self.spec.plain:
            meta["elastic"] = checkpoint.elastic_manifest(
                self._active, self.state["u_hist"].cpu().numpy(),
                **({"groups": self.trainer._n_groups,
                    "global_period": self.ecfg.global_period,
                    "g_u_hist": self.state["g_u_hist"].cpu().numpy()}
                   if hier else {}))
        meta.update(extra_metadata or {})
        # a sharded run: every rank calls, rank 0 writes
        ranks = dict(collective=self._world > 1, group=self._group)
        if hier:
            checkpoint.save(os.path.join(path, "submasters"),
                            self.layout.to_numpy(self.state["submasters"]),
                            **ranks)
        checkpoint.save(path, self.master_tree(), metadata=meta, **ranks)
        return path

    def restore(self, path: str) -> dict:
        """Warm-start this session from a checkpoint; returns its metadata.

        Plain mode replaces the params and keeps the optimizer state. An
        elastic run restores the master exactly and cold-starts every
        worker from it with fresh optimizer state (worker params are not
        checkpointed: a restore is a pool-wide rejoin); the saved live
        slots' u-histories are re-seated into this session's live slots in
        order (``checkpoint.reseat_u_hist``), also when the two capacities
        differ; any further live slot is a joiner with a blank history. A
        hierarchical session re-seats the saved sub-masters and rack
        u-histories in rack order, also at another rack count (extra racks
        start from the master; a flat checkpoint seats every rack from
        it). Raises on an architecture mismatch."""
        arch = checkpoint.read_metadata(path).get("arch")
        if arch is not None and arch != self.model_cfg.name:
            raise ValueError(
                f"checkpoint {path!r} was saved from arch {arch!r}, this "
                f"session runs {self.model_cfg.name!r}")
        # the master lives (and was saved) in float32
        like = tree_from_leaves(
            (leaf.path, torch.empty(leaf.shape, dtype=torch.float32))
            for leaf in self.layout.leaves)
        tree, meta = checkpoint.restore(path, like=like)
        if self.spec.plain:
            self.state["params"].copy_(
                self.layout.pack_tree(tree, device=self.device))
            return meta
        u_hist = checkpoint.reseat_u_hist(
            meta.get("elastic"), self.capacity, self._active,
            self.ecfg.score_window)
        state = self.trainer.init_state(tree)
        state["u_hist"] = torch.as_tensor(u_hist, device=self.device)
        if self.trainer._hier:
            sub_path = os.path.join(path, "submasters")
            saved = None
            if os.path.exists(os.path.join(sub_path, "manifest.json")):
                saved = checkpoint.restore(sub_path)[0]
            n_groups = self.trainer._n_groups
            state["submasters"] = self.layout.pack_tree(
                checkpoint.reseat_submasters(saved, tree, n_groups),
                (n_groups,), self.device)
            state["g_u_hist"] = torch.as_tensor(checkpoint.reseat_group_hist(
                (meta.get("elastic") or {}).get("g_u_hist"), n_groups,
                self.ecfg.score_window), device=self.device)
        self.state = state
        return meta

    # -- membership ----------------------------------------------------------
    def _refresh_membership(self):
        """Re-derive the per-round membership and join rows from the
        schedule; join rows stay ``None`` when no slot ever flips
        inactive→active."""
        self._membership = self.schedule.active
        joins = self.schedule.joins()
        self._join_rows = joins if joins.any() else None

    def _apply_membership(self, row: np.ndarray):
        """Host-side membership transition: remember the live mask and
        re-partition the data over the new pool (the overlap O stays put;
        only the unique shards are redealt)."""
        if np.array_equal(row, self._active):
            return
        self._active = row.copy()
        self.batcher.set_active_mask(row)

    @property
    def active_mask(self) -> np.ndarray:
        """(cap,) bool — the live-membership mask as of the next round."""
        return self._active.copy()

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    def _set_membership(self, mask: np.ndarray) -> None:
        """Live membership change between chunks: ``mask`` (cap,) bool
        becomes the pool for every remaining round, overriding the
        scheduled stream from here on. Newly live slots join at the next
        round, re-seated from the master. A fixed-k spec (no membership
        stream) gets one here."""
        if self.spec.plain:
            raise ValueError("plain mode has no worker pool to resize")
        mask = np.asarray(mask, bool)
        if mask.shape != (self.capacity,):
            raise ValueError(
                f"membership mask shape {mask.shape} != ({self.capacity},)")
        if not mask.any():
            raise ValueError("at least one worker must stay active")
        if self.round >= self.spec.rounds:
            raise ValueError("run already complete; nothing left to resize")
        rows = self.schedule.active
        if rows is None:
            rows = np.arange(self.capacity)[None] < self.ecfg.num_workers
            rows = np.repeat(rows, self.spec.rounds, axis=0)
            rows[:self.round] = self._active  # frozen history
        rows = rows.copy()
        rows[self.round:] = mask
        self.schedule = self.schedule.with_membership(rows)
        self._refresh_membership()
        self._apply_membership(mask)

    def _resize(self, k: int) -> None:
        """Pool resize to ``k``: growing activates the lowest-numbered
        vacant slots (joiners, re-seated from the master); shrinking
        retires the highest-numbered live slots."""
        if self.spec.plain:
            raise ValueError("plain mode has no worker pool to resize")
        if not 1 <= k <= self.capacity:
            raise ValueError(
                f"resize target {k} outside 1..capacity={self.capacity}")
        mask = self._active.copy()
        live = np.flatnonzero(mask)
        if k > len(live):
            vacant = np.flatnonzero(~mask)
            mask[vacant[:k - len(live)]] = True
        elif k < len(live):
            mask[live[k:]] = False
        self._set_membership(mask)

    def apply(self, action: ControlAction) -> None:
        """The single live-control entry point: execute one
        :class:`ControlAction` against the pool, between ``run`` calls or
        inside an ``on_chunk_end`` hook. ``evict`` requires its slots live
        and ``readmit`` requires them vacant: a stale action raises instead
        of half-applying (the controller's ``Actuator`` journals and
        re-scopes stale actions before calling this)."""
        if not isinstance(action, ControlAction):
            raise TypeError(
                f"ElasticSession.apply expects a ControlAction, got "
                f"{type(action).__name__}")
        if action.kind == "noop":
            return
        if action.kind == "resize":
            self._resize(action.k)
            return
        if action.kind == "set_membership":
            self._set_membership(action.mask)
            return
        if self.spec.plain:
            raise ValueError("plain mode has no worker pool to resize")
        bad = [s for s in action.slots if not 0 <= s < self.capacity]
        if bad:
            raise ValueError(
                f"{action.kind} slots {bad} outside 0..{self.capacity - 1}")
        mask = self._active.copy()
        if action.kind == "evict":
            dead = [s for s in action.slots if not mask[s]]
            if dead:
                raise ValueError(f"cannot evict vacant slots {dead}")
            mask[list(action.slots)] = False
        else:  # readmit
            live = [s for s in action.slots if mask[s]]
            if live:
                raise ValueError(f"cannot readmit live slots {live}")
            mask[list(action.slots)] = True
        self._set_membership(mask)

    def set_membership(self, mask) -> None:
        """Deprecated: use ``apply(ControlAction.set_membership(mask))``."""
        warnings.warn(
            "ElasticSession.set_membership() is deprecated; use "
            "apply(ControlAction.set_membership(mask))",
            DeprecationWarning, stacklevel=2)
        self._set_membership(mask)

    def resize(self, k: int) -> None:
        """Deprecated: use ``apply(ControlAction.resize(k))``."""
        warnings.warn(
            "ElasticSession.resize() is deprecated; use "
            "apply(ControlAction.resize(k))",
            DeprecationWarning, stacklevel=2)
        self._resize(k)

    # -- observers -------------------------------------------------------------
    def add_observer(self, observer: SessionObserver) -> None:
        """Attach an observer: ``on_round(record)`` fires for every
        completed round, ``on_chunk_end(session)`` between chunks (the
        mutation window, the only place a controller calls ``apply``).
        Both hooks are optional."""
        self._observers.append(observer)

    # -- execution ----------------------------------------------------------
    def _next_chunk(self, end: int) -> int:
        """Rounds in the next chunk: at most ``rounds_per_call``, never past
        ``end`` or the next eval round, and never across a membership
        transition (the data is re-partitioned between chunks)."""
        n = min(self.spec.rounds_per_call, end - self.round)
        if self.spec.eval_every > 0:
            for r in range(self.round, self.round + n):
                if self._is_eval_round(r):
                    n = r - self.round + 1
                    break
        if self._membership is not None:
            row = self._membership[self.round]
            for r in range(self.round + 1, self.round + n):
                if not np.array_equal(self._membership[r], row):
                    n = r - self.round
                    break
        return n

    def _run_chunk(self, n: int) -> List[RoundRecord]:
        lo, hi = self.round, self.round + n
        sched = self.schedule
        if self._membership is not None:
            # membership is constant over a chunk (_next_chunk snaps at
            # transitions): re-partition the data before drawing batches
            self._apply_membership(self._membership[lo])
        host_batches = [self.batcher.round_batches() for _ in range(n)]
        if self._sharded:  # this rank's rows only
            host_batches = [{key: np.ascontiguousarray(val[:, self._rows])
                             for key, val in b.items()} for b in host_batches]
        t0 = time.perf_counter()
        metrics = []
        for i, r in enumerate(range(lo, hi)):
            inputs = RoundInputs(
                batches=self._to_device(host_batches[i]), round=r,
                fail=sched.fail[r], failed_recent=self._failed_recent[r],
                straggle=sched.straggle[r] if sched.has_stragglers else None,
                restart=sched.restart[r] if sched.has_restarts else None,
                corrupt=sched.corrupt[r] if sched.has_corruption else None,
                speed=sched.speed[r] if sched.has_hetero else None,
                active=(None if self._membership is None
                        else self._membership[r]),
                join=(None if self._join_rows is None
                      else self._join_rows[r]))
            metrics.append(self.trainer.round_step(self.state, inputs)[1])
        t1 = time.perf_counter()
        m = {key: torch.stack([mi[key] for mi in metrics]).cpu().numpy()
             for key in metrics[0]}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        round_ms, dispatch_ms = (t2 - t0) * 1e3 / n, (t1 - t0) * 1e3
        if self._world > 1:
            # the slowest rank's times, so that every rank's records (and
            # a controller reading them) agree
            round_ms, dispatch_ms = max_over_ranks(
                [round_ms, dispatch_ms], self.device, self._group)
        self.round = hi
        echo = self._echo
        no_corrupt = np.zeros(self.capacity, bool)
        records = []
        for i, r in enumerate(range(lo, hi)):
            ev_loss = ev_acc = None
            if r == hi - 1 and self._is_eval_round(r):
                ev_loss, ev_acc = self.evaluate()
            records.append(RoundRecord(
                round=r, loss=float(m["loss"][i]),
                u=m["u"][i], score=m["score"][i],
                h1=m["h1"][i], h2=m["h2"][i],
                fail=echo.fail[r], straggle=echo.straggle[r],
                restart=echo.restart[r],
                corrupt=(echo.corrupt[r] if echo.corrupt is not None
                         else no_corrupt),
                eval_loss=ev_loss, eval_acc=ev_acc,
                active=(self._membership[r] if self._membership is not None
                        else np.ones(self.capacity, bool)),
                loss_w=m["loss_w"][i],
                round_ms=round_ms, dispatch_ms=dispatch_ms,
                **({key: m[key][i] for key in
                    ("g_u", "g_score", "g_h1", "g_h2")} if "g_u" in m
                   else {})))
        return records

    def _run_chunk_plain(self, n: int) -> List[RoundRecord]:
        """``n`` single-worker steps (one per "round"), their losses read
        back once."""
        lo, hi = self.round, self.round + n
        host_batches = [self.batcher.round_batches() for _ in range(n)]
        t0 = time.perf_counter()
        losses = []
        for i, r in enumerate(range(lo, hi)):
            # WorkerBatcher emits (τ=1, k=1, B, ...); drop the unit axes
            batch = {key: val[0, 0] for key, val in
                     self._to_device(host_batches[i]).items()}
            losses.append(self._step(self.state, batch, r)[1]["loss"])
        t1 = time.perf_counter()
        loss = torch.stack(losses).cpu().numpy()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        round_ms = (t2 - t0) * 1e3 / n
        dispatch_ms = (t1 - t0) * 1e3
        self.round = hi
        z, zb = np.zeros(1, np.float32), np.zeros(1, bool)
        records = []
        for i, r in enumerate(range(lo, hi)):
            ev_loss = ev_acc = None
            if r == hi - 1 and self._is_eval_round(r):
                ev_loss, ev_acc = self.evaluate()
            records.append(RoundRecord(
                round=r, loss=float(loss[i]), u=z, score=z, h1=z, h2=z,
                fail=zb, straggle=zb, restart=zb, corrupt=zb,
                eval_loss=ev_loss, eval_acc=ev_acc, active=~zb,
                round_ms=round_ms, dispatch_ms=dispatch_ms))
        return records

    def run_iter(self, rounds: Optional[int] = None
                 ) -> Iterator[RoundRecord]:
        """Advance up to ``rounds`` rounds (default: the rest of the run),
        yielding a :class:`RoundRecord` per round as each chunk lands."""
        remaining = (self.spec.rounds - self.round if rounds is None
                     else rounds)
        end = self.round + remaining
        if end > self.spec.rounds:
            raise ValueError(
                f"run would exceed RunSpec.rounds = {self.spec.rounds} "
                f"(at round {self.round}, asked for {rounds} more)")
        run_chunk = (self._run_chunk_plain if self.spec.plain
                     else self._run_chunk)
        while self.round < end:
            records = run_chunk(self._next_chunk(end))
            # observers run before the next chunk is built: on_chunk_end is
            # the window where a controller may apply() membership edits
            # that the following chunk then runs under
            for obs in self._observers:
                on_round = getattr(obs, "on_round", None)
                if on_round is not None:
                    for rec in records:
                        on_round(rec)
            for obs in self._observers:
                on_chunk_end = getattr(obs, "on_chunk_end", None)
                if on_chunk_end is not None:
                    on_chunk_end(self)
            yield from records
        if self.round >= self.spec.rounds and self.spec.save_path:
            self.save()

    def run(self, rounds: Optional[int] = None) -> List[RoundRecord]:
        return list(self.run_iter(rounds))
