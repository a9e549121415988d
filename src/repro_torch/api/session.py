"""`RunSpec` → `ElasticSession`: the run loop of the port's elastic trainer.

Mirrors ``repro.api.session`` for the paper's CNN under an open-loop
failure scenario. ``RunSpec`` replaces the reference's ``use_pallas`` with
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

Not ported yet, each refused by name: closed-loop control
(``controller``, ``detector_blind``, ``apply``), membership (schedules
with an ``active`` channel; see also
``repro_torch.core.coordinator.check_slice``) and LM training.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.configs.base import (ElasticConfig, ModelConfig,
                                      OptimizerConfig, get_config)
from repro_torch.core.coordinator import (ElasticTrainer, NoiseFn, ProbeFn,
                                          RoundInputs)
from repro_torch.core.scenarios import ScenarioSchedule, make_scenario
from repro_torch.data.pipeline import WorkerBatcher
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.device import resolve_device
from repro_torch.models.cnn import PaperCNN
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
    n_data: int = 8000
    n_test: int = 1000
    data_seed: int = 0
    eval_every: int = 0  # 0 = never; >0 = every e rounds + the final round
    save_path: Optional[str] = None
    device: str = "cuda"
    controller: Optional[str] = None
    detector_blind: bool = False

    def __post_init__(self):
        for name in ("rounds", "rounds_per_call", "batch_size", "n_data",
                     "n_test"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"RunSpec.{name} must be >= 1, got {v}")
        if self.eval_every < 0:
            raise ValueError(
                f"RunSpec.eval_every must be >= 0, got {self.eval_every}")
        if self.schedule is not None:
            if self.plain:
                raise ValueError(
                    "RunSpec: plain mode has no failure schedule")
            want = (self.rounds, self.elastic.cap)
            if self.schedule.fail.shape != want:
                raise ValueError(
                    f"RunSpec.schedule shape {self.schedule.fail.shape} != "
                    f"(rounds, capacity) = {want}")
        for name, unported in (("controller", self.controller),
                               ("detector_blind", self.detector_blind)):
            if unported:
                raise NotImplementedError(
                    f"RunSpec.{name} is not ported to PyTorch yet")


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One communication round, on the host (fields as in the reference:
    (k,) ``u/score/h1/h2/loss_w``, the schedule rows that drove the round,
    eval metrics on eval rounds, and the chunk's timings). In plain mode
    the diagnostics are (1,) zeros and ``loss_w`` is None."""

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
    loss_w: Optional[np.ndarray] = None
    round_ms: float = 0.0
    dispatch_ms: float = 0.0
    # (k,) bool byzantine slots of the round (all False without them)
    corrupt: Optional[np.ndarray] = None


class ElasticSession:
    """Stateful runner for one run: trainer state + schedule + batcher + eval.

    ``params`` (optional, a nested tree of arrays in the reference layout)
    seats every worker and the master (or the single worker of plain
    mode), e.g. the reference's own init carried across; ``probe_fn`` and
    ``noise_fn`` replace the probe and byzantine-noise draws (see
    ``ElasticTrainer.probe_fn``; plain mode calls ``probe_fn(step, 0, 0)``).
    ``run_iter()`` yields a :class:`RoundRecord` per round; ``run()``
    collects them.
    """

    def __init__(self, spec: RunSpec, *, params=None,
                 probe_fn: Optional[ProbeFn] = None,
                 noise_fn: Optional[NoiseFn] = None):
        self.spec = spec
        self.device = resolve_device(spec.device)
        cfg = spec.model_cfg or get_config(spec.arch, smoke=spec.smoke)
        if cfg.family != "cnn":
            raise NotImplementedError(
                f"LM training (model family {cfg.family!r}) is not ported "
                "to PyTorch yet: the card's flash-attention kernel has no "
                "backward")
        self.model_cfg = cfg
        self.model = PaperCNN(cfg)
        ecfg = spec.elastic
        if spec.plain:
            # the k=1 limit: one worker, no exchange, no failures
            ecfg = dataclasses.replace(
                ecfg, num_workers=1, capacity=0, tau=1, overlap_ratio=0.0,
                failure_prob=0.0, placement="single",
                membership_scenario="static", groups=1, global_period=1)
        self.ecfg = ecfg
        self.capacity = ecfg.cap
        self.trainer = ElasticTrainer(self.model, spec.optimizer, ecfg,
                                      device=self.device, probe_fn=probe_fn,
                                      noise_fn=noise_fn, seed=spec.seed)
        self.layout = self.trainer.layout
        # -- data -----------------------------------------------------------
        ds = SyntheticImages(n=spec.n_data, n_test=spec.n_test,
                             seed=spec.data_seed)
        self.batcher = WorkerBatcher(ds.images, ds.labels, ecfg,
                                     batch_size=spec.batch_size,
                                     seed=spec.seed)
        self._test = self._to_device(ds.test_batch())
        self.round = 0  # rounds completed so far
        if spec.plain:
            self.schedule = None
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
        if self.schedule.active is not None:
            raise NotImplementedError(
                "schedules with an active (membership) channel are not "
                "ported to PyTorch yet")
        self._failed_recent = self.schedule.failed_recent_all()
        self.state = self.trainer.init_state(params)

    def _to_device(self, batch):
        return {"images": torch.as_tensor(batch["images"]).to(self.device),
                "labels": torch.as_tensor(batch["labels"]).to(
                    self.device, torch.int64)}

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
        """(held-out loss, accuracy) of the master params."""
        params = self.layout.views(self.master_params)
        return (float(self.model.loss(params, self._test)[0]),
                float(self.model.accuracy(params, self._test)))

    def _is_eval_round(self, r: int) -> bool:
        e = self.spec.eval_every
        return e > 0 and (r % e == 0 or r == self.spec.rounds - 1)

    # -- checkpoint ---------------------------------------------------------
    def save(self, path: Optional[str] = None,
             extra_metadata: Optional[dict] = None) -> str:
        """Save the master params with the reference's metadata:
        ``{"rounds", "arch", "scenario"}``, plus, for an elastic run, the
        per-slot manifest (capacity, active mask, u-history) that
        :meth:`restore` re-seats."""
        path = path or self.spec.save_path
        if not path:
            raise ValueError("no save path: pass one or set RunSpec.save_path")
        meta = {"rounds": self.round, "arch": self.model_cfg.name,
                "scenario": ("none" if self.spec.plain
                             else self.ecfg.failure_scenario)}
        if not self.spec.plain:
            meta["elastic"] = checkpoint.elastic_manifest(
                np.ones(self.capacity, bool),
                self.state["u_hist"].cpu().numpy())
        meta.update(extra_metadata or {})
        checkpoint.save(path, self.master_tree(), metadata=meta)
        return path

    def restore(self, path: str) -> dict:
        """Warm-start this session from a checkpoint; returns its metadata.

        Plain mode replaces the params and keeps the optimizer state. An
        elastic run restores the master exactly and cold-starts every
        worker from it with fresh optimizer state (worker params are not
        checkpointed: a restore is a pool-wide rejoin); the saved live
        slots' u-histories are re-seated in order
        (``checkpoint.reseat_u_hist``). Raises on an architecture
        mismatch."""
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
            meta.get("elastic"), self.capacity, np.ones(self.capacity, bool),
            self.ecfg.score_window)
        state = self.trainer.init_state(tree)
        state["u_hist"] = torch.as_tensor(u_hist, device=self.device)
        self.state = state
        return meta

    # -- not ported yet -------------------------------------------------------
    def apply(self, *args, **kwargs):
        raise NotImplementedError("closed-loop control (ElasticSession.apply)"
                                  " is not ported to PyTorch yet")

    # -- execution ----------------------------------------------------------
    def _next_chunk(self, end: int) -> int:
        """Rounds in the next chunk: at most ``rounds_per_call``, never past
        ``end`` or the next eval round."""
        n = min(self.spec.rounds_per_call, end - self.round)
        if self.spec.eval_every > 0:
            for r in range(self.round, self.round + n):
                if self._is_eval_round(r):
                    return r - self.round + 1
        return n

    def _run_chunk(self, n: int) -> List[RoundRecord]:
        lo, hi = self.round, self.round + n
        sched = self.schedule
        host_batches = [self.batcher.round_batches() for _ in range(n)]
        t0 = time.perf_counter()
        metrics = []
        for i, r in enumerate(range(lo, hi)):
            inputs = RoundInputs(
                batches=self._to_device(host_batches[i]), round=r,
                fail=sched.fail[r], failed_recent=self._failed_recent[r],
                straggle=sched.straggle[r] if sched.has_stragglers else None,
                restart=sched.restart[r] if sched.has_restarts else None,
                corrupt=sched.corrupt[r] if sched.has_corruption else None,
                speed=sched.speed[r] if sched.has_hetero else None)
            metrics.append(self.trainer.round_step(self.state, inputs)[1])
        t1 = time.perf_counter()
        m = {key: torch.stack([mi[key] for mi in metrics]).cpu().numpy()
             for key in metrics[0]}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        round_ms = (t2 - t0) * 1e3 / n
        dispatch_ms = (t1 - t0) * 1e3
        self.round = hi
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
                fail=sched.fail[r], straggle=sched.straggle[r],
                restart=sched.restart[r],
                corrupt=(sched.corrupt[r] if sched.corrupt is not None
                         else no_corrupt),
                eval_loss=ev_loss, eval_acc=ev_acc, loss_w=m["loss_w"][i],
                round_ms=round_ms, dispatch_ms=dispatch_ms))
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
                eval_loss=ev_loss, eval_acc=ev_acc,
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
            yield from run_chunk(self._next_chunk(end))
        if self.round >= self.spec.rounds and self.spec.save_path:
            self.save()

    def run(self, rounds: Optional[int] = None) -> List[RoundRecord]:
        return list(self.run_iter(rounds))
