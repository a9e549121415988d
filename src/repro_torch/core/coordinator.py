"""Elastic-averaging coordinator (the paper's system, §V–§VI), single placement.

One round of ``ElasticTrainer.round_step``:

  1. **restarts** — crash-restart rejoins re-seat their params from the
     master.
  2. **local phase** — every worker runs τ local optimizer steps on its own
     (overlap-sharded) data. With AdaHessian each τ-step is *fused*: one
     ``torch.func.vmap`` over the workers of ``jvp(grad(loss))`` gives the
     gradients and the Hutchinson HVPs together, and one batched AdaHessian
     step updates all k workers (a CUDA kernel on the card). SGD/Momentum
     (EASGD/EAMSGD) take the plain path: vmapped gradients, one
     elementwise update.
  3. **communication phase** — workers sync with the master: u-history
     from the estimated master distance, raw score, h1/h2 (or fixed α /
     oracle), then the elastic exchange unless the failure schedule
     suppresses it. ``"sequential"`` scans the workers one by one against
     the live master (one elastic kernel per worker); ``"fused"`` scores
     all k against the round-start master and exchanges in one batched
     kernel with event-order-equivalent master weights.

State lives in persistent flat float32 buffers (``repro_torch.kernels.
flatten``), updated **in place**: ``workers``, AdaHessian ``m``/``v`` (and
momentum ``m``) are (k, n), ``master``/``master_prev`` (n,). The model
reads per-leaf views of them. ``round_step`` returns the same state dict it
was given. Everything per worker stays on the device; the host only holds
the round's masks (numpy, from the schedule).

The Hutchinson probes come through one seam, :attr:`ElasticTrainer.probe_fn`,
called per (round, τ-step, worker); a parity test injects the reference's
probes there.

Out of this slice, each refused by name: membership/capacity, hierarchy,
sharded placement, ``u_zclip``, the adversarial ``corrupt``/``speed``
channels (hetero and byzantine scenarios).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.configs.base import ElasticConfig, OptimizerConfig
from repro_torch.core import dynamic_weight as dw
from repro_torch.device import resolve_device
from repro_torch.kernels.elastic.ops import (elastic_update,
                                             elastic_update_batched)
from repro_torch.kernels.flatten import FlatLayout
from repro_torch.nn.param import init_tree
from repro_torch.optim.adahessian import spatial_average
from repro_torch.optim.base import make_optimizer
from repro_torch.optim.hutchinson import hessian_diag_with_grad

# (round, τ-step, worker) -> (hutchinson_samples, n) float32 ±1 probes
ProbeFn = Callable[[int, int, int], torch.Tensor]


@dataclasses.dataclass
class RoundInputs:
    """Everything one round consumes.

    ``batches`` holds (τ, k, B, ...) tensors on the trainer's device
    (``images`` float32 NHWC, ``labels`` int64). ``round`` keys the probe
    seam. The masks are host numpy (k,) bool rows of the schedule;
    ``straggle``/``restart`` stay ``None`` when the scenario never fires
    them.
    """

    batches: Dict[str, torch.Tensor]
    round: int
    fail: np.ndarray
    failed_recent: np.ndarray
    straggle: Optional[np.ndarray] = None
    restart: Optional[np.ndarray] = None


class RademacherProbes:
    """The default probe seam: ±1 float32 probes from a ``torch.Generator``
    on the run's device, re-seeded per (seed, round, τ-step, worker), so
    the draws do not depend on call order. Not the reference's threefry
    bits — a parity test injects those instead."""

    def __init__(self, seed: int, n: int, samples: int, device):
        self.seed, self.n, self.samples = seed, n, samples
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device)

    def __call__(self, r: int, t: int, i: int) -> torch.Tensor:
        hi, lo = np.random.SeedSequence(
            [self.seed, r, t, i]).generate_state(2, np.uint32)
        self.gen.manual_seed((int(hi) << 32) | int(lo))
        z = torch.randint(0, 2, (self.samples, self.n), generator=self.gen,
                          device=self.device, dtype=torch.float32)
        return z.mul_(2.0).sub_(1.0)


def check_slice(ecfg: ElasticConfig) -> None:
    """Refuse, by name, the features this port does not run yet."""
    missing = []
    if ecfg.capacity or ecfg.membership_scenario != "static":
        missing.append("elastic membership (capacity / membership_scenario)")
    if ecfg.hierarchical:
        missing.append("hierarchical averaging (groups / global_period)")
    if ecfg.placement != "single":
        missing.append("sharded placement")
    if ecfg.u_zclip:
        missing.append("u_zclip")
    if ecfg.failure_scenario in ("hetero", "byzantine"):
        missing.append(f"the {ecfg.failure_scenario!r} scenario's "
                       "speed/corrupt channels")
    if missing:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + "; ".join(missing))


@dataclasses.dataclass(eq=False)
class ElasticTrainer:
    model: Any
    opt_cfg: OptimizerConfig
    ecfg: ElasticConfig
    device: Any = "cuda"
    # The probe seam (see module docstring); None draws RademacherProbes
    # seeded with ``seed``.
    probe_fn: Optional[ProbeFn] = None
    seed: int = 0

    def __post_init__(self):
        check_slice(self.ecfg)
        self.device = resolve_device(self.device)
        self.opt = make_optimizer(self.opt_cfg)
        self.layout = FlatLayout(self.model.spec)
        if self.probe_fn is None:
            self.probe_fn = RademacherProbes(
                self.seed, self.layout.n, self.opt_cfg.hutchinson_samples,
                self.device)
        self._c = dw.score_coefficients(self.ecfg.score_weights,
                                        self.ecfg.score_window, self.device)

    # -- state ----------------------------------------------------------------
    def init_state(self, params=None) -> Dict[str, Any]:
        """Fresh state: every worker a copy of ``params`` (a nested tree of
        arrays in the reference layout, e.g. from ``params_from_numpy``),
        or of a parameter tree drawn from a ``torch.Generator`` seeded with
        ``seed``."""
        if params is None:
            params = init_tree(torch.Generator().manual_seed(self.seed),
                               self.model.spec)
        k, n = self.ecfg.cap, self.layout.n
        master = self.layout.pack_tree(params, device=self.device)
        return {
            "workers": master.expand(k, n).clone(),
            "opt": self.opt.init(k, n, self.device),
            "master": master,
            # previous-round master snapshot (stragglers' stale estimate,
            # the stale sync target under delayed averaging): a distinct
            # buffer, never an alias of "master"
            "master_prev": master.clone(),
            "u_hist": torch.full((k, self.ecfg.score_window), -30.0,
                                 dtype=torch.float32, device=self.device),
            "round": 0,
        }

    def state_to_numpy(self, state) -> Dict[str, Any]:
        """The full state as the reference's state tree of numpy arrays:
        ``workers``, ``opt`` (``count`` plus ``m``/``v`` trees),
        ``master``, ``master_prev``, ``u_hist``, ``round``."""
        lay = self.layout
        opt = {key: (val.cpu().numpy() if key == "count" else lay.to_numpy(val))
               for key, val in state["opt"].items()}
        return {"workers": lay.to_numpy(state["workers"]), "opt": opt,
                "master": lay.to_numpy(state["master"]),
                "master_prev": lay.to_numpy(state["master_prev"]),
                "u_hist": state["u_hist"].cpu().numpy(),
                "round": np.int32(state["round"])}

    def state_from_numpy(self, tree) -> Dict[str, Any]:
        """Inverse of :meth:`state_to_numpy`: a reference state tree (numpy
        arrays, e.g. ``jax.device_get(state)``) as this trainer's flat
        buffers on its device."""
        lay, dev, k = self.layout, self.device, self.ecfg.cap
        opt = {key: (torch.tensor(np.asarray(val), dtype=torch.int32,
                                  device=dev) if key == "count"
                     else lay.pack_tree(val, (k,), dev))
               for key, val in tree["opt"].items()}
        if set(opt) != set(self.opt.init(1, 1, "cpu")):
            raise ValueError(f"opt state keys {sorted(opt)} do not match "
                             f"optimizer {self.opt_cfg.name!r}")
        return {"workers": lay.pack_tree(tree["workers"], (k,), dev),
                "opt": opt,
                "master": lay.pack_tree(tree["master"], device=dev),
                "master_prev": lay.pack_tree(tree["master_prev"], device=dev),
                "u_hist": torch.tensor(np.asarray(tree["u_hist"]),
                                       dtype=torch.float32, device=dev),
                "round": int(tree["round"])}

    # -- failure-scenario state transitions --------------------------------------
    def apply_restarts(self, state, restart: np.ndarray) -> None:
        """Crash-restart rejoin: workers with ``restart[i]`` have their
        params re-seated from the master. The u-history and the optimizer
        accumulators are kept, as in the reference (``repro.core.
        coordinator.ElasticTrainer.apply_restarts`` gives the reasons)."""
        for i in np.flatnonzero(restart):
            state["workers"][i].copy_(state["master"])

    # -- local phase ------------------------------------------------------------
    def _loss(self, params, images, labels):
        return self.model.loss(params, {"images": images,
                                        "labels": labels})[0]

    def _fused_local_step(self, state, batch, r: int, t: int):
        """One AdaHessian τ-step for all k workers: gradients and Hutchinson
        diagonals from one vmapped ``jvp(grad)``, the diagonal spatially
        averaged per leaf, both packed into (k, n) with one ``torch.cat``
        each, then one batched update in place."""
        k, lay = self.ecfg.cap, self.layout
        z = torch.stack([self.probe_fn(r, t, i) for i in range(k)])
        probes = [lay.views(z[:, s]) for s in range(z.shape[1])]
        grads, diag, loss = hessian_diag_with_grad(
            self._loss, lay.views(state["workers"]), probes,
            batch["images"], batch["labels"])
        block = self.opt_cfg.spatial_block
        hs = {name: spatial_average(d, block, batch_dims=1)
              for name, d in diag.items()}
        self.opt.step(state["workers"], lay.pack(grads, (k,)), state["opt"],
                      lay.pack(hs, (k,)))
        return loss

    def _plain_local_step(self, state, batch):
        k, lay = self.ecfg.cap, self.layout

        def loss_and_value(p, images, labels):
            value = self._loss(p, images, labels)
            return value, value

        grads, loss = vmap(grad(loss_and_value, has_aux=True))(
            lay.views(state["workers"]), batch["images"], batch["labels"])
        self.opt.step(state["workers"], lay.pack(grads, (k,)), state["opt"])
        return loss

    def local_phase(self, state, batches, r: int,
                    straggle: Optional[np.ndarray] = None):
        """τ local steps per worker, in place. ``straggle`` (k,) bool:
        straggling workers complete only the first
        ``max(1, round(straggler_tau_scale·τ))`` steps; their params and
        optimizer state are restored after each later step (the reference
        computes and discards those steps the same way).

        Returns ``(mean_loss, loss_w)``: the mean over live (worker, step)
        losses, and the (k,) per-worker mean over its live steps."""
        k = self.ecfg.cap
        tau = batches["images"].shape[0]
        tau_eff = max(1, round(self.ecfg.straggler_tau_scale * tau))
        step_sums, loss_w = [], 0
        live_steps = np.zeros(k, np.int64)
        for t in range(tau):
            live = (np.ones(k, bool) if straggle is None
                    else ~straggle | (t < tau_eff))
            frozen = torch.as_tensor(np.flatnonzero(~live),
                                     device=self.device)
            tensors = [state["workers"], *state["opt"].values()]
            saved = [x[frozen] for x in tensors] if len(frozen) else []
            batch = {key: val[t] for key, val in batches.items()}
            if self.opt.needs_hessian:
                loss = self._fused_local_step(state, batch, r, t)
            else:
                loss = self._plain_local_step(state, batch)
            for x, old in zip(tensors, saved):
                x[frozen] = old
            if len(frozen):
                live_t = torch.as_tensor(live, device=self.device)
                loss = torch.where(live_t, loss, 0.0)
            step_sums.append(loss.sum())
            loss_w = loss_w + loss
            live_steps += live
        mean_loss = torch.stack(step_sums).sum() / max(int(live_steps.sum()), 1)
        loss_w = loss_w / torch.as_tensor(np.maximum(live_steps, 1),
                                          dtype=torch.float32,
                                          device=self.device)
        return mean_loss, loss_w

    # -- communication phase -----------------------------------------------------
    def comm_phase(self, state, fail: np.ndarray,
                   failed_recent: Optional[np.ndarray] = None,
                   straggle: Optional[np.ndarray] = None):
        """Elastic exchange under the fail mask (True suppresses a worker's
        sync), in place; returns the (k,) diagnostics ``u, score, h1, h2``.

        ``straggle``: straggling workers score against the previous round's
        master snapshot. At the end ``master_prev`` becomes a copy of the
        round-start master, taken before the exchange writes the master."""
        if failed_recent is None:
            failed_recent = np.zeros_like(fail)
        fr = torch.as_tensor(failed_recent, device=self.device)
        if self.ecfg.comm_mode == "fused":
            metrics = self._comm_phase_fused(state, fail, fr, straggle)
        else:
            metrics = self._comm_phase_sequential(state, fail, fr, straggle)
        state["round"] += 1
        return metrics

    def _comm_phase_sequential(self, state, fail, fr, straggle):
        """The paper's event-ordered scan: worker i scores against, and
        exchanges with, the master as workers 0..i−1 left it."""
        ecfg, lay = self.ecfg, self.layout
        master, workers, hist = state["master"], state["workers"], \
            state["u_hist"]
        round_start = master.clone()
        stale = state["master_prev"]
        rows = []
        for i in range(ecfg.cap):
            w_i = workers[i]
            if straggle is not None and straggle[i]:
                u = dw.log_distance(w_i, stale, lay)
            else:
                u = dw.log_distance(w_i, master, lay)
            if ecfg.score_clip > 0:
                # quarantine: a worker whose distance left float32 range is
                # re-seated to the master before the (refused) exchange
                quar = ~torch.isfinite(u)
                w_i.copy_(torch.where(quar, master, w_i))
                u = torch.where(quar, torch.log(torch.tensor(
                    1e-30, dtype=torch.float32, device=self.device)), u)
            hist[i] = dw.push_history(hist[i], u)
            a = dw.raw_score(hist[i], self._c)
            w1, w2 = dw.weights_for(ecfg, a, failed_recently=fr[i])
            if fail[i]:  # suppressed communication: no exchange
                w1, w2 = torch.zeros_like(w1), torch.zeros_like(w2)
            elastic_update(w_i, master, torch.stack([w1, w2]).reshape(2, 1))
            rows.append(torch.stack([u, a, w1, w2]))
        u, a, w1, w2 = torch.stack(rows, dim=1)
        state["master_prev"] = round_start
        return {"u": u, "score": a, "h1": w1, "h2": w2}

    def _comm_phase_fused(self, state, fail, fr, straggle):
        """Batched scoring against the round-start master (or, with
        ``staleness=1``, the previous round's snapshot) and one batched
        exchange whose master weights ``master_schedule_weights(h2)``
        reproduce the sequential scan's master when the h2 agree."""
        ecfg, lay = self.ecfg, self.layout
        master, workers = state["master"], state["workers"]
        ref = state["master_prev"] if ecfg.staleness else master
        if ecfg.score_clip > 0:
            quar = ~torch.isfinite(dw.log_distance(workers, ref, lay))
            workers.copy_(torch.where(quar[:, None], ref[None], workers))
        straggle_t = (None if straggle is None
                      else torch.as_tensor(straggle, device=self.device))
        u, hist, a, w1, w2 = dw.comm_scores_batched(
            ecfg, workers, ref, state["u_hist"], lay, c=self._c,
            failed_recently=fr,
            stale_master=None if straggle is None else state["master_prev"],
            straggle=straggle_t)
        dead = torch.as_tensor(fail, device=self.device)
        w1 = torch.where(dead, 0.0, w1)
        w2 = torch.where(dead, 0.0, w2)
        g2 = dw.master_schedule_weights(w2)
        round_start = master.clone()
        elastic_update_batched(workers, master, torch.stack([w1, g2]),
                               master_ref=ref if ecfg.staleness else None)
        state["master_prev"] = round_start
        state["u_hist"] = hist
        return {"u": u, "score": a, "h1": w1, "h2": w2}

    # -- full round ---------------------------------------------------------------
    def round_step(self, state, inputs: RoundInputs):
        """One round, in place: restarts, local phase, comm phase. Returns
        ``(state, metrics)`` with device-resident (k,) ``u, score, h1, h2,
        loss_w`` and scalar ``loss``."""
        if inputs.restart is not None:
            self.apply_restarts(state, inputs.restart)
        loss, loss_w = self.local_phase(state, inputs.batches, inputs.round,
                                        inputs.straggle)
        metrics = self.comm_phase(state, inputs.fail, inputs.failed_recent,
                                  inputs.straggle)
        metrics["loss"] = loss
        metrics["loss_w"] = loss_w
        return state, metrics

    # -- eval ----------------------------------------------------------------------
    @torch.no_grad()
    def master_accuracy(self, state, batch):
        return self.model.accuracy(self.layout.views(state["master"]), batch)

    @torch.no_grad()
    def master_loss(self, state, batch):
        return self.model.loss(self.layout.views(state["master"]), batch)[0]
