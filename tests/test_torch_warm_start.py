"""Rounds after a warm start against the JAX reference.

One checkpoint (a port session's ``save`` after two rounds) warm-starts a
session of each package: the master comes back exactly, every worker is
re-seated from it with fresh AdaHessian state, the u-histories carry over.
Both then run three rounds from there with the reference's own Rademacher
probes injected through the port's probe seam (``fold_in(key(seed), r)`` →
``split(·, τ)`` → ``split(·, k)``, as ``run_parity`` in
tests/test_torch_session.py rebuilds them). After every round the full
state is held to the ROADMAP's end-to-end tolerances — per leaf norm-wise
within 1e-3 and elementwise rtol 1e-4 with an atol of 2% of the leaf's
scale — and the round's diagnostics to rtol 1e-4, atol 1e-5 (the
tolerances of ``_assert_state_close`` / ``_close``, whose docstring gives
the reasons). The restored state is held to them with no exception.

The rounds after a restore start from fresh optimizer state: AdaHessian's
first steps divide each gradient by its Hutchinson curvature, and where
that estimate is a small sum of cancelling terms, or a max-pool window is a
near tie, a rounding difference grows. The reference alone shows it:
moving every restored worker and master element by one ulp moves worker
1's u by 2.3e-4 in round 1 at checkpoint seed ``SEED + 1`` (the port's
differs by 4.8e-4), and conv1's first moment by 1.37e-3 norm-wise in
round 1 at ``SEED + 2``, fused (the port's by the same). No tolerance can
hold the port closer to the reference than the reference holds to itself.
So each round also runs ``SPREAD_RUNS`` such perturbed copies of the
reference, and a quantity that misses its tolerance passes only where its
deviation is within ``SPREAD_FACTOR`` times the reference's own spread,
element by element (and norm-wise for a leaf that misses the norm bound).
A fault of the port (a wrong weight, a missing pull, a wrong step) moves
quantities that the perturbation leaves in place, and fails. The test runs
four checkpoint seeds in both comm modes, the two above among them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import ElasticSession as RSession
from repro.api.session import RunSpec as RSpec
from repro.configs.base import ElasticConfig as RElastic
from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.nn.param import tree_leaves
from test_torch_session import (ATOL, ELEM_ATOL_FRAC, NORM_RTOL, PARAMS,
                                RTOL, SEED, TAU, _assert_state_close,
                                _round_probes,
                                one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K, WARM_ROUNDS = 3, 3
SPREAD_RUNS, SPREAD_FACTOR = 2, 4.0
RECORD_KEYS = ("loss", "u", "score", "h1", "h2", "loss_w", "eval_loss",
               "eval_acc")


def _kw(rounds, **kw):
    base = dict(rounds=rounds, batch_size=4, n_data=200, n_test=16,
                seed=SEED, eval_every=1)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _compiled(comm):
    """A reference session per comm mode whose jitted round and eval the
    file's reference sessions share: jit caches by the trainer object, so
    sharing it compiles the round once per process instead of once per
    session (three sessions a case, eight cases)."""
    return RSession(RSpec(elastic=RElastic(num_workers=K, tau=TAU,
                                           comm_mode=comm),
                          **_kw(WARM_ROUNDS)))


def _share_compiled(sess, comm):
    shared = _compiled(comm)
    sess.trainer = shared.trainer
    sess._eval_loss, sess._eval_acc = shared._eval_loss, shared._eval_acc
    return sess


def _nudge(state, seed):
    """``state`` with every worker and master element moved one ulp up or
    down at random (``master_prev`` follows the master)."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        up = rng.random(x.shape) < 0.5
        return jnp.asarray(np.where(up, np.nextafter(x, np.float32(np.inf)),
                                    np.nextafter(x, np.float32(-np.inf))))

    state = dict(state)
    for key in ("workers", "master"):
        state[key] = jax.tree.map(one, state[key])
    state["master_prev"] = jax.tree.map(jnp.copy, state["master"])
    return state


def _quantities(state):
    """Every compared array of a state, flat: each parameter leaf over
    workers, master and master_prev together, each optimizer moment leaf,
    and the u-history (marked False: a diagnostic's tolerance)."""
    out = {}
    for path, _ in tree_leaves(state["master"]):
        out["params/" + ".".join(path)] = (np.concatenate(
            [np.ravel(dict(tree_leaves(state[e]))[path]) for e in PARAMS]),
            True)
    for key in sorted(set(state["opt"]) - {"count"}):
        for path, leaf in tree_leaves(state["opt"][key]):
            out[f"opt/{key}/" + ".".join(path)] = np.ravel(leaf), True
    out["u_hist"] = np.ravel(state["u_hist"]), False
    return out


def _agree(got, want, spreads, is_state, msg):
    """``got`` within the tolerances of ``want``, or, where not, within
    ``SPREAD_FACTOR`` times the reference's own spread (``spreads``: the
    perturbed references' values)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    atol = ELEM_ATOL_FRAC * np.abs(want).max() if is_state else ATOL
    bad = d > RTOL * np.abs(want) + atol
    norm = np.linalg.norm(want)
    norm_bad = is_state and np.linalg.norm(d) > NORM_RTOL * norm
    if not bad.any() and not norm_bad:
        return
    spread = np.max([np.abs(np.asarray(s, np.float64) - want)
                     for s in spreads], axis=0)
    over = bad & (d > SPREAD_FACTOR * spread)
    assert not over.any(), (
        f"{msg}: {int(over.sum())} element(s) off beyond tolerance and "
        f"beyond {SPREAD_FACTOR}x the reference's spread, first at "
        f"{np.argwhere(over)[0].tolist()}: got {got[over][0]!r}, want "
        f"{want[over][0]!r}, spread {spread[over][0]!r}")
    if norm_bad:
        assert np.linalg.norm(d) <= SPREAD_FACTOR * max(
            np.linalg.norm(np.asarray(s, np.float64) - want)
            for s in spreads), (
            f"{msg}: |d|/|want| = {np.linalg.norm(d) / norm:.2e}, beyond "
            f"tolerance and {SPREAD_FACTOR}x the reference's spread")


def _assert_round_close(got, want, spreads, msg):
    np.testing.assert_array_equal(got["opt"]["count"], want["opt"]["count"])
    assert set(got["opt"]) == set(want["opt"])
    assert int(got["round"]) == int(want["round"])
    g, w = _quantities(got), _quantities(want)
    s = [_quantities(x) for x in spreads]
    for name, (arr, is_state) in w.items():
        _agree(g[name][0], arr, [x[name][0] for x in s], is_state,
               f"{msg} {name}")


@pytest.mark.parametrize("ck_seed", [1, 2, 3, 4])
@pytest.mark.parametrize("comm", ["sequential", "fused"])
def test_rounds_after_restore_match_reference(tmp_path, comm, ck_seed):
    ekw = dict(num_workers=K, tau=TAU, comm_mode=comm)
    path = str(tmp_path / "ck")
    ElasticSession(RunSpec(elastic=TElastic(**ekw), device="cpu",
                           save_path=path,
                           **_kw(2, seed=SEED + ck_seed))).run()

    refs = [_share_compiled(RSession(RSpec(elastic=RElastic(**ekw),
                                           **_kw(WARM_ROUNDS))), comm)
            for _ in range(1 + SPREAD_RUNS)]
    probes = {r: torch.from_numpy(_round_probes(
        jax.random.fold_in(jax.random.key(SEED), r), K))
        for r in range(WARM_ROUNDS)}
    sess = ElasticSession(
        RunSpec(elastic=TElastic(**ekw), device="cpu", **_kw(WARM_ROUNDS)),
        probe_fn=lambda r, t, i: probes[r][t, i][None])
    meta = sess.restore(path)
    assert all(ref.restore(path) == meta for ref in refs)
    ref, spread = refs[0], refs[1:]
    _assert_state_close(sess.trainer.state_to_numpy(sess.state),
                        jax.device_get(ref.state), "restored")
    for i, other in enumerate(spread):
        other.state = _nudge(other.state, i)

    for r in range(WARM_ROUNDS):
        (want,), (got,) = ref.run(1), sess.run(1)
        others = [other.run(1)[0] for other in spread]
        assert got.round == want.round == r
        _assert_round_close(sess.trainer.state_to_numpy(sess.state),
                            jax.device_get(ref.state),
                            [jax.device_get(o.state) for o in spread],
                            f"warm round {r}")
        for key in RECORD_KEYS:
            w, g = getattr(want, key), getattr(got, key)
            assert (w is None) == (g is None), key
            if w is not None:
                _agree(g, w, [getattr(o, key) for o in others], False,
                       f"warm round {r} {key}")
