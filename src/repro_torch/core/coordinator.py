"""Elastic-averaging coordinator (the paper's system, §V–§VI).

One round of ``ElasticTrainer.round_step``:

  1. **restarts** — crash-restart rejoins re-seat their params from the
     master.
  2. **local phase** — every worker runs τ local optimizer steps on its own
     (overlap-sharded) data, ``model.loss(params, batch)`` for any model
     family (the CNN's images, an LM's tokens). With AdaHessian each τ-step
     is *fused*: one
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
probes there. The byzantine ``noise`` draws come through a second seam of
the same shape, :attr:`ElasticTrainer.noise_fn`.

Adversarial channels (``RoundInputs.corrupt`` / ``speed``, the
``byzantine`` and ``hetero`` scenarios): a corrupt slot's gradient is
replaced every τ-step by ``ElasticConfig.byzantine_mode``'s poison before
the optimizer reads it (the Hutchinson diagonal is left alone, as in the
reference); a slot of speed s runs ``max(1, round(s·τ))`` local steps and
freezes for the rest of the phase, in either comm mode.

Elastic membership: the worker axis is sized at ``ElasticConfig.cap``
slots, and ``RoundInputs.active`` selects the live ones. An inactive
(vacant) slot is frozen end to end: its rows of the in-place AdaHessian
step are restored after each τ-step, it adds neither loss nor count to the
mean loss, it exchanges nothing (``dead = fail | ~active``: h1 = h2 = 0
into the elastic kernels), its u-history stays as it was, and it reports
zeroed u, score, h1 and h2. Slots in ``RoundInputs.join`` are re-seated
from the master before the local phase, the same operation as a
crash-restart rejoin. With ``active`` / ``join`` left ``None`` (a fixed-k
run) nothing is masked, and an all-True mask gives the same bits.

Hierarchical averaging (tree-EASGD; ``ElasticConfig.groups`` /
``global_period``, fused comm only): the slot axis is split into G
contiguous racks (``dynamic_weight.group_assignment``), each with a
sub-master in ``state["submasters"]`` (G, n). Every round each worker
scores against its rack's sub-master and exchanges with it (one batched
elastic kernel per rack, on the rack's row block), with event-order
weights per rack. Every ``global_period`` rounds the sub-masters play the
worker role against the master: their own u-history ``g_u_hist``, scores,
h1/h2 and one batched exchange. Restarts and joins still re-seat from the
master.

Sharded placement (``ElasticConfig.placement = "sharded"``, fused comm):
the slot axis is split over the ranks of a ``torch.distributed`` process
group (``ElasticTrainer.group``, else the default group, else world size
1), rank r holding the contiguous slots ``repro_torch.launch.mesh.
shard_slots`` gives it. The state holds the rank's rows of ``workers`` and
of the optimizer state; ``master``, ``master_prev``, ``u_hist``,
``submasters`` and ``g_u_hist`` are whole and replicated. A round runs the
restarts, joins and the local phase on the rank's rows (the probe and
noise seams and every mask keyed by global slot), takes the mean loss as an
``all_reduce`` of (sum, count), then gathers the worker rows
(``gather_rows``, cap × n × 4 bytes), runs the single-placement comm phase
unchanged on the full (cap, n) buffer on every rank — so every rank's
master and sub-masters are bit-identical, and bit-identical to single
placement given the same pre-comm workers — and keeps its own rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import grad, vmap

from repro_torch.configs.base import ElasticConfig, OptimizerConfig
from repro_torch.core import dynamic_weight as dw
from repro_torch.device import resolve_device
from repro_torch.kernels.elastic.ops import (elastic_update,
                                             elastic_update_batched,
                                             elastic_update_grouped)
from repro_torch.kernels.flatten import FlatLayout
from repro_torch.launch.mesh import gather_rows, shard_slots, world_and_rank
from repro_torch.nn.param import init_tree
from repro_torch.optim.adahessian import spatial_average
from repro_torch.optim.base import make_optimizer
from repro_torch.optim.hutchinson import hessian_diag_with_grad

# (round, τ-step, worker) -> (hutchinson_samples, n) float32 ±1 probes
ProbeFn = Callable[[int, int, int], torch.Tensor]
# (round, τ-step, worker) -> (n,) float32 standard-normal byzantine noise
NoiseFn = Callable[[int, int, int], torch.Tensor]


@dataclasses.dataclass
class RoundInputs:
    """Everything one round consumes.

    ``batches`` holds (τ, k, B, ...) tensors on the trainer's device: the
    model's batch dict (``images`` float32 NHWC and ``labels`` int64 for
    the CNN, ``tokens`` and ``targets`` int64 for an LM); the local phase
    maps over every entry. ``round`` keys the probe
    seam. The masks are host numpy (k,) rows of the schedule;
    ``straggle``/``restart`` stay ``None`` when the scenario never fires
    them, and so do the adversarial channels: ``corrupt`` (k,) bool
    byzantine slots, ``speed`` (k,) float32 persistent speeds in (0, 1].
    Membership: ``active`` (k,) bool live slots (``None``: all live) and
    ``join`` (k,) bool slots (re)joining this round, re-seated from the
    master (``None``: no join).
    """

    batches: Dict[str, torch.Tensor]
    round: int
    fail: np.ndarray
    failed_recent: np.ndarray
    straggle: Optional[np.ndarray] = None
    restart: Optional[np.ndarray] = None
    corrupt: Optional[np.ndarray] = None
    speed: Optional[np.ndarray] = None
    active: Optional[np.ndarray] = None
    join: Optional[np.ndarray] = None


def _reseed(gen: torch.Generator, *words: int) -> torch.Generator:
    """Seed ``gen`` from a ``SeedSequence`` of ``words``, so a seam's
    draws depend on its key, not on the order of the calls."""
    hi, lo = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return gen.manual_seed((int(hi) << 32) | int(lo))


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
        z = torch.randint(0, 2, (self.samples, self.n),
                          generator=_reseed(self.gen, self.seed, r, t, i),
                          device=self.device, dtype=torch.float32)
        return z.mul_(2.0).sub_(1.0)


class GaussianNoise:
    """The default byzantine-noise seam: (n,) float32 N(0, 1) draws from a
    ``torch.Generator`` on the run's device, re-seeded per (seed, round,
    τ-step, worker) apart from the probes' stream. Not the reference's
    threefry bits — a parity test injects those instead."""

    SALT = 0x6B7A  # the reference folds the same constant into its keys

    def __init__(self, seed: int, n: int, device):
        self.seed, self.n = seed, n
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device)

    def __call__(self, r: int, t: int, i: int) -> torch.Tensor:
        return torch.randn(self.n, device=self.device, generator=_reseed(
            self.gen, self.seed, self.SALT, r, t, i))


@dataclasses.dataclass(eq=False)
class ElasticTrainer:
    model: Any
    opt_cfg: OptimizerConfig
    ecfg: ElasticConfig
    device: Any = "cuda"
    # The probe seam (see module docstring); None draws RademacherProbes
    # seeded with ``seed``.
    probe_fn: Optional[ProbeFn] = None
    # The byzantine-noise seam; None draws GaussianNoise seeded with ``seed``.
    noise_fn: Optional[NoiseFn] = None
    seed: int = 0
    # Hierarchical averaging: None follows ``ecfg.hierarchical`` (groups > 1
    # or global_period > 1); an explicit True forces the hierarchical state
    # and comm phase even at groups=1, global_period=1, where the round is
    # the flat fused one bit for bit (the degenerate proof runs this).
    hierarchical: Optional[bool] = None
    # Sharded placement: the process group the slot axis is split over;
    # None takes the default group, or world size 1 when none is
    # initialised.
    group: Any = None
    # Workers mapped per ``vmap`` call of the local phase (None: all of
    # this rank's at once). Fewer bound the activations that
    # ``vmap(jvp(grad))`` keeps alive, which an LM at a long batch needs,
    # at the cost of more, smaller kernel launches.
    worker_chunk: Optional[int] = None

    def __post_init__(self):
        self._sharded = self.ecfg.placement == "sharded"
        self._world, self._rank = (world_and_rank(self.group)
                                   if self._sharded else (1, 0))
        # the slots this rank holds: all of them at single placement
        self._lo, self._hi = shard_slots(self.ecfg.cap, self._world,
                                         self._rank)
        self._hier = (self.ecfg.hierarchical if self.hierarchical is None
                      else bool(self.hierarchical))
        if self._hier:
            if self.ecfg.comm_mode != "fused":
                raise ValueError(
                    "hierarchical averaging needs comm_mode='fused' (the "
                    "sequential scan has no grouped equivalent)")
            if self.ecfg.staleness:
                raise ValueError(
                    "hierarchical averaging is incompatible with "
                    "staleness=1 (there is no stale sub-master snapshot)")
            # static slot → rack map; rack count after clamping to capacity
            self._grp = dw.group_assignment(self.ecfg.cap, self.ecfg.groups)
            self._n_groups = int(self._grp.max()) + 1
        self.device = resolve_device(self.device)
        self.opt = make_optimizer(self.opt_cfg)
        self.layout = FlatLayout(self.model.spec)
        if self.probe_fn is None:
            self.probe_fn = RademacherProbes(
                self.seed, self.layout.n, self.opt_cfg.hutchinson_samples,
                self.device)
        if self.noise_fn is None:
            self.noise_fn = GaussianNoise(self.seed, self.layout.n,
                                          self.device)
        self._c = dw.score_coefficients(self.ecfg.score_weights,
                                        self.ecfg.score_window, self.device)

    # -- state ----------------------------------------------------------------
    def init_state(self, params=None) -> Dict[str, Any]:
        """Fresh state: every worker a copy of ``params`` (a nested tree of
        arrays in the reference layout, e.g. from ``params_from_numpy``),
        or of a parameter tree drawn from a ``torch.Generator`` seeded with
        ``seed``. Under sharded placement ``workers`` and ``opt`` hold this
        rank's rows only."""
        if params is None:
            params = init_tree(torch.Generator().manual_seed(self.seed),
                               self.model.spec)
        k, n = self.ecfg.cap, self.layout.n
        rows = self._hi - self._lo
        master = self.layout.pack_tree(params, device=self.device)
        state = {
            "workers": master.expand(rows, n).clone(),
            "opt": self.opt.init(rows, n, self.device),
            "master": master,
            # previous-round master snapshot (stragglers' stale estimate,
            # the stale sync target under delayed averaging): a distinct
            # buffer, never an alias of "master"
            "master_prev": master.clone(),
            "u_hist": torch.full((k, self.ecfg.score_window), -30.0,
                                 dtype=torch.float32, device=self.device),
            "round": 0,
        }
        if self._hier:
            # one sub-master per rack, a master copy like the workers; the
            # racks' u-history has the workers' window
            g = self._n_groups
            state["submasters"] = master.expand(g, n).clone()
            state["g_u_hist"] = torch.full(
                (g, self.ecfg.score_window), -30.0, dtype=torch.float32,
                device=self.device)
        return state

    def state_to_numpy(self, state) -> Dict[str, Any]:
        """The full state as the reference's state tree of numpy arrays:
        ``workers``, ``opt`` (``count`` plus ``m``/``v`` trees),
        ``master``, ``master_prev``, ``u_hist``, ``round``, and for a
        hierarchical trainer ``submasters`` (a param tree with a leading
        (G,) axis) and ``g_u_hist``. Under sharded placement every slot's
        rows are gathered first: a collective, called on every rank."""
        lay = self.layout
        rows = lambda x: gather_rows(x, self.group) if self._sharded else x
        opt = {key: (rows(val).cpu().numpy() if key == "count"
                     else lay.to_numpy(rows(val)))
               for key, val in state["opt"].items()}
        out = {"workers": lay.to_numpy(rows(state["workers"])), "opt": opt,
               "master": lay.to_numpy(state["master"]),
               "master_prev": lay.to_numpy(state["master_prev"]),
               "u_hist": state["u_hist"].cpu().numpy(),
               "round": np.int32(state["round"])}
        if self._hier:
            out["submasters"] = lay.to_numpy(state["submasters"])
            out["g_u_hist"] = state["g_u_hist"].cpu().numpy()
        return out

    def state_from_numpy(self, tree) -> Dict[str, Any]:
        """Inverse of :meth:`state_to_numpy`: a reference state tree (numpy
        arrays, e.g. ``jax.device_get(state)``) as this trainer's flat
        buffers on its device; under sharded placement, of this rank's
        rows."""
        lay, dev, k = self.layout, self.device, self.ecfg.cap
        mine = slice(self._lo, self._hi)
        opt = {key: (torch.tensor(np.asarray(val)[mine], dtype=torch.int32,
                                  device=dev) if key == "count"
                     else lay.pack_tree(val, (k,), dev)[mine].clone())
               for key, val in tree["opt"].items()}
        if set(opt) != set(self.opt.init(1, 1, "cpu")):
            raise ValueError(f"opt state keys {sorted(opt)} do not match "
                             f"optimizer {self.opt_cfg.name!r}")
        hist = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                                      device=dev)
        state = {"workers": lay.pack_tree(tree["workers"], (k,),
                                          dev)[mine].clone(),
                 "opt": opt,
                 "master": lay.pack_tree(tree["master"], device=dev),
                 "master_prev": lay.pack_tree(tree["master_prev"],
                                              device=dev),
                 "u_hist": hist(tree["u_hist"]),
                 "round": int(tree["round"])}
        if self._hier:
            state["submasters"] = lay.pack_tree(
                tree["submasters"], (self._n_groups,), dev)
            state["g_u_hist"] = hist(tree["g_u_hist"])
        return state

    # -- failure-scenario state transitions --------------------------------------
    def apply_restarts(self, state, restart: np.ndarray) -> None:
        """Crash-restart rejoin: workers with ``restart[i]`` (a mask over
        this rank's rows) have their params re-seated from the master. The u-history and the optimizer
        accumulators are kept, as in the reference (``repro.core.
        coordinator.ElasticTrainer.apply_restarts`` gives the reasons)."""
        for i in np.flatnonzero(restart):
            state["workers"][i].copy_(state["master"])

    # -- byzantine gradient corruption ----------------------------------------------
    def corrupt_grads(self, grads: torch.Tensor, corrupt: np.ndarray, r: int,
                      t: int) -> None:
        """Replace, in place, the (k, n) gradient rows of the corrupt slots
        (``corrupt`` over this rank's rows) by the adversarial gradient of
        ``ecfg.byzantine_mode``
        (``repro.core.coordinator.ElasticTrainer._poison``): ``sign_flip``
        ascends the loss, ``scale`` overshoots by ``byzantine_scale``×,
        ``noise`` adds ``byzantine_scale``·N(0, 1) drawn through
        :attr:`noise_fn` for (round, τ-step, worker)."""
        mode, c = self.ecfg.byzantine_mode, self.ecfg.byzantine_scale
        for i in np.flatnonzero(corrupt):
            g = grads[i]
            if mode == "sign_flip":
                g.neg_()
            elif mode == "scale":
                g.mul_(c)
            else:
                g.add_(c * self.noise_fn(r, t, self._lo + int(i)))

    # -- local phase ------------------------------------------------------------
    def _loss(self, params, batch):
        return self.model.loss(params, batch)[0]

    def _fused_local_step(self, state, batch, r: int, t: int, corrupt=None):
        """One AdaHessian τ-step for all k workers: gradients and Hutchinson
        diagonals from one vmapped ``jvp(grad)``, the diagonal spatially
        averaged per leaf, both packed into (k, n) with one ``torch.cat``
        each (the corrupt slots' gradients poisoned), then one batched
        update in place, over this rank's rows (probes keyed by global
        slot). Each (k, n)-sized temporary is dropped as soon as the next
        is built, so at the update the step holds two (the packed gradient
        and diagonal) beside the state: an LM's n makes each one GBs."""
        k, lay = self._hi - self._lo, self.layout
        z = torch.stack([self.probe_fn(r, t, i)
                         for i in range(self._lo, self._hi)])
        probes = [lay.views(z[:, s]) for s in range(z.shape[1])]
        grads, diag, loss = hessian_diag_with_grad(
            self._loss, lay.views(state["workers"]), probes, batch,
            chunk_size=self.worker_chunk)
        del z, probes
        block = self.opt_cfg.spatial_block
        hs = {name: spatial_average(d, block, batch_dims=1)
              for name, d in diag.items()}
        del diag
        g = lay.pack(grads, (k,))
        del grads
        if corrupt is not None:
            self.corrupt_grads(g, corrupt, r, t)
        h = lay.pack(hs, (k,))
        del hs
        self.opt.step(state["workers"], g, state["opt"], h)
        return loss

    def _plain_local_step(self, state, batch, r: int, t: int, corrupt=None):
        k, lay = self._hi - self._lo, self.layout

        def loss_and_value(p, b):
            value = self._loss(p, b)
            return value, value

        grads, loss = vmap(grad(loss_and_value, has_aux=True),
                           chunk_size=self.worker_chunk)(
            lay.views(state["workers"]), batch)
        g = lay.pack(grads, (k,))
        if corrupt is not None:
            self.corrupt_grads(g, corrupt, r, t)
        self.opt.step(state["workers"], g, state["opt"])
        return loss

    def local_phase(self, state, batches, r: int,
                    straggle: Optional[np.ndarray] = None,
                    corrupt: Optional[np.ndarray] = None,
                    speed: Optional[np.ndarray] = None,
                    active: Optional[np.ndarray] = None):
        """τ local steps per worker, in place. ``straggle`` (k,) bool:
        straggling workers complete only the first
        ``max(1, round(straggler_tau_scale·τ))`` steps; ``speed`` (k,)
        float32: slot i completes only the first ``max(1, round(speed_i·τ))``
        steps (rounded half to even in float32, as ``jnp.round``); the two
        compose. Past its budget a slot's params and optimizer state are
        restored after each step (the reference computes and discards
        those steps the same way). ``corrupt`` (k,) bool: those slots'
        gradients are poisoned every step (:meth:`corrupt_grads`).
        ``active`` (k,) bool: vacant slots are frozen for every step and
        count neither loss nor steps. Under sharded placement ``batches``
        and every mask cover this rank's rows.

        Returns ``(mean_loss, loss_w)``: the mean over live (worker, step)
        losses of every rank (an ``all_reduce`` of sum and count), and the
        (k,) per-worker mean over its live steps, of this rank's rows."""
        k = self._hi - self._lo
        tau = next(iter(batches.values())).shape[0]
        tau_eff = max(1, round(self.ecfg.straggler_tau_scale * tau))
        speed_steps = (None if speed is None else np.maximum(
            1, np.round(np.asarray(speed, np.float32) * np.float32(tau))))
        step_sums, loss_w = [], 0
        live_steps = np.zeros(k, np.int64)
        for t in range(tau):
            live = (np.ones(k, bool) if straggle is None
                    else ~straggle | (t < tau_eff))
            if speed_steps is not None:
                live = live & (t < speed_steps)
            if active is not None:
                live = live & active
            frozen = torch.as_tensor(np.flatnonzero(~live),
                                     device=self.device)
            tensors = [state["workers"], *state["opt"].values()]
            saved = [x[frozen] for x in tensors] if len(frozen) else []
            batch = {key: val[t] for key, val in batches.items()}
            step = (self._fused_local_step if self.opt.needs_hessian
                    else self._plain_local_step)
            loss = step(state, batch, r, t, corrupt)
            for x, old in zip(tensors, saved):
                x[frozen] = old
            if len(frozen):
                live_t = torch.as_tensor(live, device=self.device)
                loss = torch.where(live_t, loss, 0.0)
            step_sums.append(loss.sum())
            loss_w = loss_w + loss
            live_steps += live
        total, n_live = torch.stack(step_sums).sum(), int(live_steps.sum())
        if self._world > 1:
            buf = torch.stack([total, total.new_tensor(float(n_live))])
            dist.all_reduce(buf, group=self.group)
            mean_loss = buf[0] / buf[1].clamp(min=1.0)
        else:
            mean_loss = total / max(n_live, 1)
        loss_w = loss_w / torch.as_tensor(np.maximum(live_steps, 1),
                                          dtype=torch.float32,
                                          device=self.device)
        return mean_loss, loss_w

    # -- communication phase -----------------------------------------------------
    def comm_phase(self, state, fail: np.ndarray,
                   failed_recent: Optional[np.ndarray] = None,
                   straggle: Optional[np.ndarray] = None,
                   active: Optional[np.ndarray] = None):
        """Elastic exchange under the fail mask (True suppresses a worker's
        sync), in place; returns the (k,) diagnostics ``u, score, h1, h2``
        (a hierarchical trainer adds its racks' (G,) ``g_u, g_score, g_h1,
        g_h2``, zero on rounds without a global sync).

        ``straggle``: straggling workers score against the previous round's
        master snapshot. ``active``: a vacant slot is not a failed worker —
        it exchanges nothing, its u-history stays frozen and its
        diagnostics read zero. At the end ``master_prev`` becomes a copy of
        the round-start master, taken before the exchange writes the
        master.

        Under sharded placement the masks cover every slot, and the phase
        is a collective: the worker rows of every rank are gathered
        (:func:`~repro_torch.launch.mesh.gather_rows`), the exchange runs
        on the full (cap, n) buffer on every rank, and this rank keeps its
        rows."""
        if failed_recent is None:
            failed_recent = np.zeros_like(fail)
        fr = torch.as_tensor(failed_recent, device=self.device)
        full = state
        if self._sharded:
            full = dict(state, workers=gather_rows(state["workers"],
                                                   self.group))
        if self._hier:
            metrics = self._comm_phase_hier(full, fail, failed_recent, fr,
                                            straggle, active)
        elif self.ecfg.comm_mode == "fused":
            metrics = self._comm_phase_fused(full, fail, fr, straggle,
                                             active)
        else:
            metrics = self._comm_phase_sequential(full, fail, fr, straggle,
                                                  active)
        full["round"] += 1
        if full is not state:
            if full["workers"] is not state["workers"]:
                state["workers"].copy_(full["workers"][self._lo:self._hi])
            state.update((key, val) for key, val in full.items()
                         if key != "workers")
        return metrics

    def _comm_phase_sequential(self, state, fail, fr, straggle, active):
        """The paper's event-ordered scan: worker i scores against, and
        exchanges with, the master as workers 0..i−1 left it. A vacant slot
        exchanges with zero weights, a no-op on the master, so the live
        workers' event order is that of a pool without it."""
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
            live = active is None or active[i]
            if live:
                hist[i] = dw.push_history(hist[i], u)
            a = dw.raw_score(hist[i], self._c)
            w1, w2 = dw.weights_for(ecfg, a, failed_recently=fr[i])
            if fail[i] or not live:  # suppressed communication or vacancy
                w1, w2 = torch.zeros_like(w1), torch.zeros_like(w2)
            elastic_update(w_i, master, torch.stack([w1, w2]).reshape(2, 1))
            if not live:  # vacant slots report zeroed diagnostics
                u, a = torch.zeros_like(u), torch.zeros_like(a)
            rows.append(torch.stack([u, a, w1, w2]))
        u, a, w1, w2 = torch.stack(rows, dim=1)
        state["master_prev"] = round_start
        return {"u": u, "score": a, "h1": w1, "h2": w2}

    def _comm_phase_fused(self, state, fail, fr, straggle, active):
        """Batched scoring against the round-start master (or, with
        ``staleness=1``, the previous round's snapshot) and one batched
        exchange whose master weights ``master_schedule_weights(h2)``
        reproduce the sequential scan's master when the h2 agree. A vacant
        slot enters the exchange with h1 = h2 = 0 (g_i = 0), keeps its
        u-history and is left out of the ``u_zclip`` pool statistics."""
        ecfg, lay = self.ecfg, self.layout
        master, workers = state["master"], state["workers"]
        ref = state["master_prev"] if ecfg.staleness else master
        if ecfg.score_clip > 0:
            quar = ~torch.isfinite(dw.log_distance(workers, ref, lay))
            workers.copy_(torch.where(quar[:, None], ref[None], workers))
        straggle_t = (None if straggle is None
                      else torch.as_tensor(straggle, device=self.device))
        active_t = (None if active is None
                    else torch.as_tensor(active, device=self.device))
        u, hist, a, w1, w2 = dw.comm_scores_batched(
            ecfg, workers, ref, state["u_hist"], lay, c=self._c,
            failed_recently=fr,
            stale_master=None if straggle is None else state["master_prev"],
            straggle=straggle_t, active=active_t)
        dead = torch.as_tensor(fail if active is None else fail | ~active,
                               device=self.device)
        w1 = torch.where(dead, 0.0, w1)
        w2 = torch.where(dead, 0.0, w2)
        if active is not None:
            hist = torch.where(active_t[:, None], hist, state["u_hist"])
            u = torch.where(active_t, u, 0.0)
            a = torch.where(active_t, a, 0.0)
        g2 = dw.master_schedule_weights(w2)
        round_start = master.clone()
        elastic_update_batched(workers, master, torch.stack([w1, g2]),
                               master_ref=ref if ecfg.staleness else None)
        state["master_prev"] = round_start
        state["u_hist"] = hist
        return {"u": u, "score": a, "h1": w1, "h2": w2}

    def _comm_phase_hier(self, state, fail, failed_recent, fr, straggle,
                         active):
        """Two-level hierarchical exchange (``repro.core.coordinator.
        ElasticTrainer._comm_phase_hier``, step for step).

        Rack level, every round: each worker scores against its rack's
        sub-master (the ``score_clip`` quarantine re-seats it to that
        sub-master), h1/h2 as in the flat fused phase over the whole pool,
        ``dead = fail | ~active`` zeroed, then the rack exchange with
        per-rack event-order weights: one batched kernel per rack.

        Global level, on rounds with ``(round + 1) % global_period == 0``:
        the sub-masters score against the master with their own
        ``g_u_hist`` (pushed only for racks with a live member), h1/h2 over
        the racks, zero for a rack none of whose members synced this round,
        then one batched exchange of the (G, n) sub-masters with the master.
        Off-cycle rounds touch neither master nor ``g_u_hist`` and report
        zero ``g_*``. Rack liveness comes from the host masks. Stragglers
        score against their live sub-master (there is no stale one).

        Degenerate topology (one rack, global period 1): the flat fused
        phase, bit for bit, with the lone sub-master set to the new master
        and zero (1,) ``g_*``."""
        ecfg, lay, dev = self.ecfg, self.layout, self.device
        G = self._n_groups
        if G == 1 and ecfg.global_period == 1:
            metrics = self._comm_phase_fused(state, fail, fr, straggle,
                                             active)
            state["submasters"].copy_(state["master"][None])
            z = torch.zeros(1, dtype=torch.float32, device=dev)
            metrics.update(g_u=z, g_score=z, g_h1=z, g_h2=z)
            return metrics
        grp = self._grp
        master, workers = state["master"], state["workers"]
        subs = state["submasters"]
        u = dw.log_distance_grouped(workers, subs, grp, lay)
        if ecfg.score_clip > 0:
            # quarantine as in the flat fused phase; the re-seat target is
            # the worker's sub-master, and the recorded u is that of the
            # re-seated worker (log 1e-30)
            quar = ~torch.isfinite(u)
            for g, (s, e) in enumerate(dw.rack_bounds(grp, G)):
                workers[s:e] = torch.where(quar[s:e, None], subs[g],
                                           workers[s:e])
            u = torch.where(quar, torch.log(torch.tensor(
                1e-30, dtype=torch.float32, device=dev)), u)
        active_t = (None if active is None
                    else torch.as_tensor(active, device=dev))
        hist = dw.push_history(state["u_hist"], u)
        a = dw.raw_score(hist, self._c)
        w1, w2 = dw.weights_for(ecfg, a, failed_recently=fr, u=u,
                                live=active_t)
        dead = fail if active is None else fail | ~active
        dead_t = torch.as_tensor(dead, device=dev)
        w1 = torch.where(dead_t, 0.0, w1)
        w2 = torch.where(dead_t, 0.0, w2)
        if active is not None:
            hist = torch.where(active_t[:, None], hist, state["u_hist"])
            u = torch.where(active_t, u, 0.0)
            a = torch.where(active_t, a, 0.0)
        g2 = dw.master_schedule_weights_grouped(w2, grp)
        elastic_update_grouped(workers, subs, torch.stack([w1, g2]), grp)
        state["u_hist"] = hist

        # rack liveness from the host masks
        seg_any = lambda b: np.bincount(grp, weights=np.asarray(b, bool),
                                        minlength=G) > 0
        g_synced = seg_any(~dead)  # some member exchanged
        g_live = np.ones(G, bool) if active is None else seg_any(active)
        g_fr = seg_any(failed_recent)
        round_start = master.clone()
        z = torch.zeros(G, dtype=torch.float32, device=dev)
        g_u = g_a = gw1 = gw2 = z
        if (state["round"] + 1) % ecfg.global_period == 0:
            live_t = torch.as_tensor(g_live, device=dev)
            g_u = dw.log_distance(subs, master, lay)
            g_hist = dw.push_history(state["g_u_hist"], g_u)
            g_hist = torch.where(live_t[:, None], g_hist, state["g_u_hist"])
            g_a = dw.raw_score(g_hist, self._c)
            gw1, gw2 = dw.weights_for(
                ecfg, g_a, failed_recently=torch.as_tensor(g_fr, device=dev),
                u=g_u, live=live_t)
            g_dead = torch.as_tensor(~g_synced, device=dev)
            gw1 = torch.where(g_dead, 0.0, gw1)
            gw2 = torch.where(g_dead, 0.0, gw2)
            elastic_update_batched(subs, master, torch.stack(
                [gw1, dw.master_schedule_weights(gw2)]))
            g_u = torch.where(live_t, g_u, 0.0)
            g_a = torch.where(live_t, g_a, 0.0)
            state["g_u_hist"] = g_hist
        state["master_prev"] = round_start
        return {"u": u, "score": a, "h1": w1, "h2": w2,
                "g_u": g_u, "g_score": g_a, "g_h1": gw1, "g_h2": gw2}

    # -- full round ---------------------------------------------------------------
    def round_step(self, state, inputs: RoundInputs):
        """One round, in place: restarts and joins (both re-seat from the
        master), local phase, comm phase. Returns ``(state, metrics)`` with
        device-resident (k,) ``u, score, h1, h2, loss_w`` and scalar
        ``loss``, every slot's on every rank.

        Under sharded placement ``inputs.batches`` holds this rank's rows
        (τ, cap/world, B, …) and the masks every slot; the restarts, joins
        and local phase run on the rank's rows, the comm phase on all."""
        mine = slice(self._lo, self._hi)
        rows = lambda x: None if x is None else x[mine]
        reseat = inputs.restart
        if inputs.join is not None:
            reseat = (inputs.join if reseat is None
                      else reseat | inputs.join)
        if reseat is not None:
            self.apply_restarts(state, reseat[mine])
        loss, loss_w = self.local_phase(
            state, inputs.batches, inputs.round, rows(inputs.straggle),
            rows(inputs.corrupt), rows(inputs.speed), rows(inputs.active))
        metrics = self.comm_phase(state, inputs.fail, inputs.failed_recent,
                                  inputs.straggle, inputs.active)
        metrics["loss"] = loss
        metrics["loss_w"] = (gather_rows(loss_w, self.group)
                             if self._sharded else loss_w)
        return state, metrics
