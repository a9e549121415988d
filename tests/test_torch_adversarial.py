"""The adversarial channels of the port against the JAX reference: byzantine
gradient corruption (``sign_flip``, ``scale``, ``noise``), persistent
heterogeneous speeds (``hetero``) and the ``u_zclip`` / ``score_clip``
clamps, a few rounds each through ``ElasticTrainer.round_step``.

``run_adversarial`` is ``run_parity``'s harness (tests/test_torch_session.py)
with the round's ``corrupt`` and ``speed`` rows fed to both trainers. The
Hutchinson probes and, for ``noise``, the byzantine draws are the
reference's own, rebuilt from its key chain (worker key
``split(split(fold_in(key(seed), r), τ)[t], k)[i]``; noise
``normal(split(fold_in(worker key, 0x6B7A), leaves)[j])`` per leaf,
``repro/core/coordinator.py`` ``_poison``) and injected through the port's
``probe_fn`` / ``noise_fn`` seams. Tolerances are ``run_parity``'s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ElasticConfig as RElastic
from repro.configs.base import OptimizerConfig as ROpt
from repro.configs.base import get_config as rget
from repro.core.coordinator import ElasticTrainer as RTrainer
from repro.core.coordinator import RoundInputs as RInputs
from repro.core.scenarios import make_scenario
from repro.data.pipeline import WorkerBatcher
from repro.data.synthetic import SyntheticImages
from repro.models.cnn import PaperCNN as RCNN
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import get_config as tget
from repro_torch.core.coordinator import ElasticTrainer as TTrainer
from repro_torch.core.coordinator import RoundInputs as TInputs
from repro_torch.models.cnn import PaperCNN as TCNN
from test_torch_session import (SEED, TAU, _assert_state_close, _close,
                                _initial_params, _round_probes,
                                one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROUNDS, BATCH = 3, 2


@functools.lru_cache(maxsize=None)
def _worker_noise():
    """Jitted worker key -> the (n,) flat byzantine noise ``_poison`` adds
    (before its ``byzantine_scale`` factor)."""
    leaves = jax.tree.leaves(_initial_params())

    def noise(key):
        keys = jax.random.split(jax.random.fold_in(key, 0x6B7A), len(leaves))
        return jnp.concatenate(
            [jax.random.normal(kk, x.shape, jnp.float32).reshape(-1)
             for kk, x in zip(keys, leaves)])

    return jax.jit(noise)


def _round_noise(rng, k):
    one = _worker_noise()
    return np.stack([np.stack([np.asarray(one(key))
                               for key in jax.random.split(rt, k)])
                     for rt in jax.random.split(rng, TAU)])


def schedule_for(ekw, k, seed=SEED + 7, rounds=ROUNDS):
    return make_scenario(RElastic(**ekw)).schedule(seed, rounds, k)


def run_adversarial(ekw, okw, sched, k, rounds=ROUNDS, log=None):
    """``rounds`` rounds of the reference and the port from one carried
    state, every round's state and diagnostics compared; each round's port
    diagnostics are appended to ``log`` when one is given."""
    model = RCNN(rget("paper-cnn"))
    rtrainer = RTrainer(model, ROpt(**okw), RElastic(**ekw))
    rstate = rtrainer.init_state(jax.random.key(SEED),
                                 params=_initial_params())
    state0 = jax.device_get(rstate)
    probes, noise = {}, {}
    ttrainer = TTrainer(TCNN(tget("paper-cnn")), TOpt(**okw),
                        TElastic(**ekw), device="cpu",
                        probe_fn=lambda r, t, i: probes[r][t, i][None],
                        noise_fn=lambda r, t, i: noise[r][t, i])
    tstate = ttrainer.state_from_numpy(state0)
    ds = SyntheticImages(n=256, n_test=8, seed=1)
    batcher = WorkerBatcher(ds.images, ds.labels, RElastic(**ekw),
                            batch_size=BATCH, seed=SEED)
    failed_recent = sched.failed_recent_all()
    corrupt = sched.corrupt if sched.has_corruption else None
    speed = sched.speed if sched.has_hetero else None
    noisy = corrupt is not None and ekw.get("byzantine_mode") == "noise"
    for r in range(rounds):
        b = batcher.round_batches()
        rng = jax.random.fold_in(jax.random.key(SEED), r)
        rstate, rmet = rtrainer.round_step(rstate, RInputs(
            batches={key: jnp.asarray(v) for key, v in b.items()}, rng=rng,
            fail=jnp.asarray(sched.fail[r]),
            failed_recent=jnp.asarray(failed_recent[r]),
            corrupt=None if corrupt is None else jnp.asarray(corrupt[r]),
            speed=None if speed is None else jnp.asarray(speed[r])))
        if okw["name"] == "adahessian":
            probes[r] = torch.from_numpy(_round_probes(rng, k))
        if noisy:
            noise[r] = torch.from_numpy(_round_noise(rng, k))
        tstate, tmet = ttrainer.round_step(tstate, TInputs(
            batches={"images": torch.from_numpy(b["images"]),
                     "labels": torch.from_numpy(b["labels"]).long()},
            round=r, fail=sched.fail[r], failed_recent=failed_recent[r],
            corrupt=None if corrupt is None else corrupt[r],
            speed=None if speed is None else speed[r]))
        _assert_state_close(ttrainer.state_to_numpy(tstate),
                            jax.device_get(rstate), f"round {r}")
        for key, want in jax.device_get(rmet).items():
            _close(tmet[key].numpy(), want, f"round {r} metric {key}")
        if log is not None:
            log.append(tmet)
    return tstate, tmet


ADAHESSIAN = dict(name="adahessian", lr=0.01, betas=(0.9, 0.999))


@pytest.mark.parametrize("mode,comm,opt", [
    ("sign_flip", "sequential", "adahessian"),
    ("scale", "fused", "adahessian"),
    ("sign_flip", "fused", "sgd")])
def test_byzantine_matches_reference(mode, comm, opt):
    """Deterministic corruption: the poisoned slots' gradients, and every
    state after them, agree with the reference (AdaHessian's fused local
    step and SGD's plain one)."""
    k = 4
    ekw = dict(num_workers=k, tau=TAU, alpha=0.1, comm_mode=comm,
               failure_scenario="byzantine", byzantine_frac=0.5,
               byzantine_mode=mode, byzantine_scale=5.0)
    sched = schedule_for(ekw, k)
    assert sched.has_corruption and not sched.corrupt[0].all()
    okw = ADAHESSIAN if opt == "adahessian" else dict(name="sgd", lr=0.01)
    run_adversarial(ekw, okw, sched, k)


@pytest.mark.parametrize("dist", ["lognormal", "bimodal"])
def test_hetero_speeds_match_reference(dist):
    """Persistent speeds: slot i runs max(1, round(speed_i·τ)) steps and
    freezes; the frozen slots' params, moments and counts stay put as in
    the reference."""
    k = 4
    ekw = dict(num_workers=k, tau=TAU, alpha=0.1,
               failure_scenario="hetero", hetero_dist=dist,
               hetero_slow_frac=0.5, hetero_sigma=1.0)
    sched = schedule_for(ekw, k)
    budgets = np.maximum(1, np.round(sched.speed[0] * np.float32(TAU)))
    assert sched.has_hetero and (budgets < TAU).any() and (budgets == TAU).any()
    tstate, _ = run_adversarial(ekw, ADAHESSIAN, sched, k)
    np.testing.assert_array_equal(tstate["opt"]["count"].numpy(),
                                  ROUNDS * budgets.astype(np.int32))
