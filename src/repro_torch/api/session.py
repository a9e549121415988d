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

Not ported yet, each refused by name: ``plain`` mode, checkpoints
(``save_path``, ``save``/``restore``), closed-loop control
(``controller``, ``detector_blind``, ``apply``), membership and the
adversarial channels (see ``repro_torch.core.coordinator.check_slice``),
and the LM families.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ElasticConfig, ModelConfig,
                                      OptimizerConfig, get_config)
from repro_torch.core.coordinator import ElasticTrainer, ProbeFn, RoundInputs
from repro_torch.core.scenarios import ScenarioSchedule, make_scenario
from repro_torch.data.pipeline import WorkerBatcher
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.device import resolve_device
from repro_torch.models.cnn import PaperCNN


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
            want = (self.rounds, self.elastic.cap)
            if self.schedule.fail.shape != want:
                raise ValueError(
                    f"RunSpec.schedule shape {self.schedule.fail.shape} != "
                    f"(rounds, capacity) = {want}")
        for name, unported in (("plain", self.plain),
                               ("save_path", self.save_path),
                               ("controller", self.controller),
                               ("detector_blind", self.detector_blind)):
            if unported:
                raise NotImplementedError(
                    f"RunSpec.{name} is not ported to PyTorch yet")


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One communication round, on the host (fields as in the reference:
    (k,) ``u/score/h1/h2/loss_w``, the schedule row that drove the round,
    eval metrics on eval rounds, and the chunk's timings)."""

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


class ElasticSession:
    """Stateful runner for one run: trainer state + schedule + batcher + eval.

    ``params`` (optional, a nested tree of arrays in the reference layout)
    seats every worker and the master, e.g. the reference's own init
    carried across; ``probe_fn`` replaces the trainer's probe draws (see
    ``ElasticTrainer.probe_fn``). ``run_iter()`` yields a
    :class:`RoundRecord` per round; ``run()`` collects them.
    """

    def __init__(self, spec: RunSpec, *, params=None,
                 probe_fn: Optional[ProbeFn] = None):
        self.spec = spec
        self.device = resolve_device(spec.device)
        cfg = spec.model_cfg or get_config(spec.arch, smoke=spec.smoke)
        if cfg.family != "cnn":
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported to PyTorch yet")
        self.model_cfg = cfg
        self.model = PaperCNN(cfg)
        ecfg = self.ecfg = spec.elastic
        self.capacity = ecfg.cap
        self.trainer = ElasticTrainer(self.model, spec.optimizer, ecfg,
                                      device=self.device, probe_fn=probe_fn,
                                      seed=spec.seed)
        # -- data -----------------------------------------------------------
        ds = SyntheticImages(n=spec.n_data, n_test=spec.n_test,
                             seed=spec.data_seed)
        self.batcher = WorkerBatcher(ds.images, ds.labels, ecfg,
                                     batch_size=spec.batch_size,
                                     seed=spec.seed)
        self._test = self._to_device(ds.test_batch())
        # -- schedule -------------------------------------------------------
        if spec.schedule is not None:
            self.schedule = spec.schedule
        else:
            sseed = (spec.scenario_seed if spec.scenario_seed is not None
                     else spec.seed + 7)
            self.schedule = make_scenario(ecfg).schedule(
                sseed, spec.rounds, self.capacity)
        if (self.schedule.active is not None or self.schedule.has_corruption
                or self.schedule.has_hetero):
            raise NotImplementedError(
                "schedules with active/corrupt/speed channels are not "
                "ported to PyTorch yet")
        self._failed_recent = self.schedule.failed_recent_all()
        self.state = self.trainer.init_state(params)
        self.round = 0  # rounds completed so far

    def _to_device(self, batch):
        return {"images": torch.as_tensor(batch["images"]).to(self.device),
                "labels": torch.as_tensor(batch["labels"]).to(
                    self.device, torch.int64)}

    # -- eval ---------------------------------------------------------------
    def evaluate(self):
        """(held-out loss, accuracy) of the master params."""
        return (float(self.trainer.master_loss(self.state, self._test)),
                float(self.trainer.master_accuracy(self.state, self._test)))

    def _is_eval_round(self, r: int) -> bool:
        e = self.spec.eval_every
        return e > 0 and (r % e == 0 or r == self.spec.rounds - 1)

    # -- not ported yet -------------------------------------------------------
    def save(self, *args, **kwargs):
        raise NotImplementedError("checkpoints (ElasticSession.save) are not "
                                  "ported to PyTorch yet")

    def restore(self, *args, **kwargs):
        raise NotImplementedError("checkpoints (ElasticSession.restore) are "
                                  "not ported to PyTorch yet")

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
                restart=sched.restart[r] if sched.has_restarts else None)
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
                eval_loss=ev_loss, eval_acc=ev_acc, loss_w=m["loss_w"][i],
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
        while self.round < end:
            yield from self._run_chunk(self._next_chunk(end))

    def run(self, rounds: Optional[int] = None) -> List[RoundRecord]:
        return list(self.run_iter(rounds))
