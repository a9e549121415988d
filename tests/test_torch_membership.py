"""Elastic membership in the port, against the JAX reference and against
itself, on the CPU.

Parity: DEAHES-O at capacity 6 with 4 live slots, ``scale_up`` to 6 at
round 2 and ``crash_restart`` failures, 4 rounds in each comm mode. The
reference ``ElasticTrainer`` and the port's trainer start from one carried
state, eat the same batches — the reference's ``WorkerBatcher``,
re-partitioned at the transition as ``ElasticSession`` does — and the same
schedule rows (``active``, ``join``, ``fail``, ``restart``); the port's
probe seam gets the reference's Rademacher probes. After every round the
state and the diagnostics are held to ``tests/test_torch_session.py``'s
tolerances (state norm-wise 1e-3 and elementwise rtol 1e-4 with atol 2% of
the leaf's scale; diagnostics and u-history rtol 1e-4, atol 1e-5). Each
round starts from the reference's state, and a slot whose max-pool argmax
the two frameworks pick differently is left out of that round's
comparison (``run_membership_parity`` says why and where).
``tests/test_torch_parity_membership_*.py`` run it, one file per comm
mode.

Inside the port (bit for bit): an all-True mask gives the fixed-k run;
vacant slots stay frozen and report zeroed records; a join re-seats the
slot from the master; the mean loss counts live slots only; chunking does
not move a result across a 4→2→6 plan; a scaled-down run's checkpoint
restores into a larger capacity and scales up. The session's membership
rows and data re-partitions are the reference session's for every
membership scenario.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ElasticSession as RSession
from repro.api import RunSpec as RSpec
from repro.configs.base import ElasticConfig as RElastic
from repro.configs.base import OptimizerConfig as ROpt
from repro.configs.base import get_config as rget
from repro.core.coordinator import ElasticTrainer as RTrainer
from repro.core.coordinator import RoundInputs as RInputs
from repro.core.scenarios import make_membership, make_scenario
from repro.data.pipeline import WorkerBatcher as RBatcher
from repro.data.synthetic import SyntheticImages
from repro.experiments import paper_repro as rpaper
from repro.models import cnn as rcnn
from repro.models.cnn import PaperCNN as RCNN
from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import get_config as tget
from repro_torch.core.coordinator import ElasticTrainer as TTrainer
from repro_torch.core.coordinator import RoundInputs as TInputs
from repro_torch.data.pipeline import WorkerBatcher as TBatcher
from repro_torch.models import cnn as tcnn
from repro_torch.models.cnn import PaperCNN as TCNN
from repro_torch.nn.param import tree_leaves
from test_torch_session import (BATCH, NORM_RTOL, SEED, TAU,
                                _assert_state_close,
                                _close, _initial_params, _round_probes,
                                one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K0, CAP, ROUNDS = 4, 6, 4


def _parity_configs(comm):
    ekw = dict(num_workers=K0, capacity=CAP, tau=TAU, alpha=rpaper.ALPHA,
               overlap_ratio=rpaper.paper_overlap_ratio(K0), dynamic=True,
               comm_mode=comm, membership_scenario="scale_up",
               membership_k=CAP, membership_round=2,
               failure_scenario="crash_restart", crash_downtime=1)
    okw = dict(name="adahessian", lr=rpaper.LR, betas=(0.9, 0.999))
    return ekw, okw


@functools.lru_cache(maxsize=None)
def _reference(comm):
    ekw, okw = _parity_configs(comm)
    trainer = RTrainer(RCNN(rget("paper-cnn")), ROpt(**okw), RElastic(**ekw))
    state0 = jax.device_get(trainer.init_state(jax.random.key(SEED),
                                               params=_initial_params()))
    return trainer, state0


def _argmax_flips(params, images):
    """Max-pool windows (of conv2's output) whose argmax the two frameworks
    pick differently, from the same float32 params (a reference-layout
    tree of numpy arrays) and images: reassociation moves a near tie."""
    def windows(a):
        B, H, W, C = a.shape
        return a.reshape(B, H // 2, 2, W // 2, 2, C).transpose(
            0, 1, 3, 5, 2, 4).reshape(B, H // 2, W // 2, C, 4).argmax(-1)

    x = jax.nn.relu(rcnn._conv(jnp.asarray(images), params["conv1"]["w"],
                               params["conv1"]["b"]))
    want = jax.nn.relu(rcnn._conv(x, params["conv2"]["w"],
                                  params["conv2"]["b"]))
    tp = {k: {n: torch.from_numpy(np.array(v)) for n, v in d.items()}
          for k, d in params.items()}
    y = torch.relu(tcnn._conv(torch.from_numpy(images), tp["conv1"]["w"],
                              tp["conv1"]["b"]))
    got = torch.relu(tcnn._conv(y, tp["conv2"]["w"], tp["conv2"]["b"]))
    return int((windows(np.asarray(want)) != windows(got.numpy())).sum())


def _flip_slots(trainer, start, batches, r, reseat, active, probes):
    """Live slots with an argmax flip (``_argmax_flips``) at some τ-step of
    round ``r``: step t is checked on the port's params after t steps
    from ``start`` (the port's own local phase, advanced one step at a
    time with the round's probes), and that step's images."""
    state = trainer.state_from_numpy(start)
    trainer.apply_restarts(state, reseat)
    flips = set()
    for t in range(TAU):
        params = trainer.state_to_numpy(state)["workers"]
        for i in np.flatnonzero(active):
            if _argmax_flips(jax.tree.map(lambda x: x[i], params),
                             batches["images"][t, i]):
                flips.add(int(i))
        step = {"images": torch.from_numpy(batches["images"][t:t + 1]),
                "labels": torch.from_numpy(batches["labels"][t:t + 1]).long()}
        seam = trainer.probe_fn
        trainer.probe_fn = lambda rr, tt, i, t=t: probes[rr][t + tt, i][None]
        trainer.local_phase(state, step, r, active=active)
        trainer.probe_fn = seam
    return sorted(flips)


def _diverged_rows(got, want):
    """(slot, fc1 input row) pairs whose AdaHessian first or second moment
    differs from the reference's by more than 1% of the row's largest
    magnitude. One pooled feature feeds one fc1 row; where its curvature
    estimate is a small sum of cancelling terms, or a relu or max-pool
    near tie reroutes it, a rounding difference moves that row's moments
    by O(1) and leaves the other rows in place (ROADMAP Queue 3)."""
    rows = set()
    for key in ("m", "v"):
        g = np.asarray(got["opt"][key]["fc1"]["w"])
        w = np.asarray(want["opt"][key]["fc1"]["w"])
        rel = np.abs(g - w).max(-1) / (np.abs(w).max(-1) + 1e-30)
        rows |= {tuple(x) for x in np.argwhere(rel > 1e-2).tolist()}
    return sorted(rows)


def _assert_round_close_except(got, want, skip, msg):
    """``_assert_state_close`` and its tolerances over every slot but
    ``skip``, the master and master_prev included, with the rows of
    ``_diverged_rows`` (under 0.5% of fc1's rows) taken out of the
    elementwise fc1 checks after every leaf has met its norm-wise bound
    with them in."""
    keep = np.setdiff1d(np.arange(np.asarray(want["u_hist"]).shape[0]),
                        list(skip))
    cut = lambda s: dict(s, workers=jax.tree.map(
        lambda x: np.array(x)[keep], s["workers"]), opt={
        key: (np.asarray(val)[keep] if key == "count" else
              jax.tree.map(lambda x: np.array(x)[keep], val))
        for key, val in s["opt"].items()},
        u_hist=np.asarray(s["u_hist"])[keep],
        master=jax.tree.map(np.array, s["master"]),
        master_prev=jax.tree.map(np.array, s["master_prev"]))
    got, want = cut(got), cut(want)
    rows = _diverged_rows(got, want)
    n_rows = want["master"]["fc1"]["w"].shape[0]
    assert len(rows) <= 0.005 * n_rows * len(keep), f"{msg}: {rows}"
    norms = {}
    for e in ("workers", "master", "master_prev"):
        norms[e] = (got[e]["fc1"]["w"], want[e]["fc1"]["w"])
    for key in ("m", "v"):
        norms[key] = (got["opt"][key]["fc1"]["w"],
                      want["opt"][key]["fc1"]["w"])
    d = np.concatenate([np.ravel(g - w) for g, w in norms.values()][:3])
    ref = np.concatenate([np.ravel(w) for _, w in norms.values()][:3])
    assert np.linalg.norm(d) <= NORM_RTOL * np.linalg.norm(ref), \
        f"{msg} params/fc1.w: norm"
    for key in ("m", "v"):
        g, w = norms[key]
        assert np.linalg.norm(g - w) <= NORM_RTOL * np.linalg.norm(w), \
            f"{msg} opt/{key}/fc1.w: norm"
    for i, row in rows:
        for key in ("workers", "m", "v"):
            g, w = norms[key]
            g[i, row] = w[i, row]
    for e in ("master", "master_prev"):
        g, w = norms[e]
        g[[row for _, row in rows]] = w[[row for _, row in rows]]
    _assert_state_close(got, want, msg)


def run_membership_parity(comm):
    """Scale-up 4 → 6 at round 2 under crash_restart, per round: each
    round starts the port from the reference's state at that round's
    start, and its state and diagnostics are held to the reference's
    (``_assert_state_close`` / ``_close``); on the port's side vacant
    slots stay frozen (unless a restart re-seats them, as in the
    reference) with zeroed records, and joiners re-seat.

    Two exceptions, each a rounding difference amplified in one place
    and checked for that shape (ROADMAP Queue 3):

    - a slot for which the two frameworks pick a different max-pool argmax
      at one of the round's τ-steps, from identical params and images
      (``_flip_slots``), is left out of that round's comparison: the flip
      reroutes one pooled feature's gradient and Hutchinson product and
      moves the slot's conv moments by O(1e-3) of the leaf. Measured: one
      window of slot 3 at round 3's first step, sequential (conv1's first
      moment then misses the norm-wise bound, 1.05e-3 against 1e-3). At
      most one slot a round;
    - fc1 rows whose moments diverge alone (``_diverged_rows``) are held
      norm-wise only. Measured: slot 2 in round 2, 9–10 of 9,216 rows,
      one element off by 1.07e-3 sequential and 1.13e-3 fused against
      the 1.02e-3 elementwise bound, with no argmax flip at either step.

    Every other slot, the master and the other slots' diagnostics stay
    held."""
    rtrainer, state0 = _reference(comm)
    ekw, okw = _parity_configs(comm)
    ecfg = RElastic(**ekw)
    sched = make_scenario(ecfg).schedule(SEED + 7, ROUNDS, CAP)
    active = make_membership(ecfg).active_schedule(ROUNDS, CAP, K0)
    sched = sched.with_membership(active)
    joins, failed_recent = sched.joins(), sched.failed_recent_all()
    assert sched.has_restarts and joins[2].sum() == CAP - K0
    probes = {}
    ttrainer = TTrainer(TCNN(tget("paper-cnn")), TOpt(**okw),
                        TElastic(**ekw), device="cpu",
                        probe_fn=lambda r, t, i: probes[r][t, i][None])
    rstate = jax.tree.map(jnp.asarray, state0)
    ds = SyntheticImages(n=256, n_test=8, seed=1)
    batcher = RBatcher(ds.images, ds.labels, ecfg, batch_size=BATCH,
                       seed=SEED)
    for r in range(ROUNDS):
        batcher.set_active_mask(active[r])
        b = batcher.round_batches()
        rng = jax.random.fold_in(jax.random.key(SEED), r)
        inputs = RInputs(
            batches={key: jnp.asarray(v) for key, v in b.items()}, rng=rng,
            fail=jnp.asarray(sched.fail[r]),
            failed_recent=jnp.asarray(failed_recent[r]),
            restart=jnp.asarray(sched.restart[r]),
            active=jnp.asarray(active[r]), join=jnp.asarray(joins[r]))
        start = jax.device_get(rstate)
        probes[r] = torch.from_numpy(_round_probes(rng, CAP))
        rstate, rmet = rtrainer.round_step(rstate, inputs)
        want, wmet = jax.device_get((rstate, rmet))
        flips = _flip_slots(ttrainer, start, b, r, sched.restart[r] | joins[r],
                            active[r], probes)
        assert len(flips) <= 1, (r, flips)
        # every round starts from the reference's state, so each round's
        # comparison measures that round alone (a flip does not compound)
        tstate = ttrainer.state_from_numpy(start)
        before = tstate["workers"].clone()
        tstate, tmet = ttrainer.round_step(tstate, TInputs(
            batches={"images": torch.from_numpy(b["images"]),
                     "labels": torch.from_numpy(b["labels"]).long()},
            round=r, fail=sched.fail[r], failed_recent=failed_recent[r],
            restart=sched.restart[r], active=active[r], join=joins[r]))
        msg = f"{comm} round {r}"
        _assert_round_close_except(ttrainer.state_to_numpy(tstate), want,
                                   flips, msg)
        keep = np.setdiff1d(np.arange(CAP), flips)
        for key, val in wmet.items():
            got = tmet[key].numpy()
            _close(got if got.ndim == 0 else got[keep],
                   val if np.ndim(val) == 0 else val[keep], f"{msg} {key}")
        vacant = ~active[r]
        # a vacant slot is frozen; a restart drawn for it still re-seats
        # it from the master, in the reference as here
        kept = vacant & ~sched.restart[r]
        assert torch.equal(tstate["workers"][kept], before[kept])
        for key in ("u", "score", "h1", "h2", "loss_w"):
            assert not tmet[key][vacant].any(), (r, key)
        if joins[r].any():  # joiners start the round from the master
            assert not torch.equal(tstate["workers"][joins[r]],
                                   before[joins[r]])


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

def _spec(**kw):
    ekw = dict(num_workers=2, tau=1, dynamic=True, failure_prob=0.4)
    ekw.update(kw.pop("elastic", {}))
    base = dict(optimizer=TOpt(name="adahessian"), elastic=TElastic(**ekw),
                rounds=4, batch_size=4, n_data=96, n_test=16, device="cpu",
                seed=1)
    base.update(kw)
    return RunSpec(**base)


@pytest.mark.parametrize("comm", ["sequential", "fused"])
def test_all_active_mask_bit_exact_vs_fixed_k(comm):
    spec = _spec(elastic=dict(comm_mode=comm,
                              failure_scenario="crash_restart"))
    fixed = ElasticSession(spec)
    sched = fixed.schedule
    masked = ElasticSession(spec.replace(
        schedule=sched.with_membership(np.ones((4, 2), bool))))
    for a, b in zip(fixed.run(), masked.run()):
        for key in ("u", "score", "h1", "h2", "loss_w"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
        assert a.loss == b.loss
    for key in ("workers", "master", "u_hist"):
        assert torch.equal(fixed.state[key], masked.state[key])


def _trainer(comm, cap=3, k=2):
    return TTrainer(TCNN(tget("paper-cnn")), TOpt(name="adahessian"),
                    TElastic(num_workers=k, capacity=cap, tau=1,
                             dynamic=True, comm_mode=comm), device="cpu")


def _inputs(cap, active=None, join=None):
    return TInputs(batches={"images": torch.ones(1, cap, 2, 28, 28, 1),
                            "labels": torch.zeros(1, cap, 2,
                                                  dtype=torch.long)},
                   round=0, fail=np.zeros(cap, bool),
                   failed_recent=np.zeros(cap, bool),
                   active=None if active is None else np.asarray(active),
                   join=None if join is None else np.asarray(join))


@pytest.mark.parametrize("comm", ["sequential", "fused"])
def test_vacant_slot_fully_frozen(comm):
    """A vacant slot neither trains (params and AdaHessian state restored
    around the in-place step) nor syncs nor pushes u-history, and reports
    zeros."""
    tr = _trainer(comm)
    state = tr.init_state()
    state["workers"][2] = 7.0
    state["u_hist"][2] = 5.0
    before = {key: val[2].clone() for key, val in
              [("workers", state["workers"]), *state["opt"].items()]}
    master = state["master"].clone()
    _, m = tr.round_step(state, _inputs(3, active=[True, True, False]))
    for key, val in [("workers", state["workers"]), *state["opt"].items()]:
        assert torch.equal(val[2], before[key]), key
    assert torch.equal(state["u_hist"][2], torch.full((5,), 5.0))
    assert not torch.equal(state["master"], master)  # the live pool synced
    for key in ("u", "score", "h1", "h2", "loss_w"):
        assert m[key][2] == 0.0, key
    assert torch.isfinite(m["loss"])


def test_join_reseats_slot_from_master():
    """A joining slot starts its first local phase as a copy of the
    master: with the same start it ends the round as a run whose slot was
    never poisoned."""
    tr = _trainer("sequential")
    clean = tr.init_state()
    state = tr.init_state()
    state["workers"][2] = 1e6
    join = [False, False, True]
    _, m = tr.round_step(state, _inputs(3, active=[True] * 3, join=join))
    tr.round_step(clean, _inputs(3, active=[True] * 3, join=join))
    assert torch.equal(state["workers"], clean["workers"])
    assert torch.equal(state["master"], clean["master"])
    assert torch.isfinite(m["loss"])


def test_mean_loss_counts_live_slots_only():
    tr = _trainer("fused")
    a, b = tr.init_state(), tr.init_state()
    _, m_all = tr.round_step(a, _inputs(3))
    _, m_live = tr.round_step(b, _inputs(3, active=[True, True, False]))
    # identical per-slot data (all-ones batches) -> identical mean loss
    torch.testing.assert_close(m_live["loss"], m_all["loss"], rtol=1e-6,
                               atol=0)
    assert m_live["loss_w"][2] == 0.0 and m_all["loss_w"][2] > 0.0


def _plan(comm="sequential", **kw):
    return dict(num_workers=4, capacity=8, comm_mode=comm,
                membership_scenario="plan",
                membership_plan=((2, 2), (4, 6)), **kw)


@pytest.mark.parametrize("comm", ["sequential", "fused"])
def test_membership_chunking_invariant(comm):
    """Chunks snap to the transitions of a 4 → 2 → 6 plan: per-round and
    three-round chunks agree bit for bit; the data follows the pool."""
    spec = _spec(elastic=_plan(comm), rounds=6,
                 optimizer=TOpt(name="momentum"))
    a = ElasticSession(spec)
    ra = a.run()
    b = ElasticSession(spec.replace(rounds_per_call=3))
    chunks, rb = [], []
    while b.round < 6:
        rb += b.run(b._next_chunk(6))
        chunks.append(b.round)
        assert b.batcher.active == tuple(np.flatnonzero(rb[-1].active))
    assert chunks == [2, 4, 6]
    assert [r.num_active for r in ra] == [4, 4, 2, 2, 6, 6]
    assert torch.equal(a.state["master"], b.state["master"])
    assert torch.equal(a.state["workers"], b.state["workers"])
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x.active, y.active)
        np.testing.assert_array_equal(x.h2, y.h2)
        assert x.loss == y.loss
    for rec in ra:
        np.testing.assert_array_equal(rec.h2[~rec.active], 0.0)
        np.testing.assert_array_equal(rec.u[~rec.active], 0.0)


def test_scale_down_checkpoint_restore_scale_up(tmp_path):
    """A scaled-down run saves its membership manifest; a session at a
    larger capacity restores it (master exact, every slot re-seated from
    the master, the live slots' u-histories carried across in order),
    then scales up with joiners taken from the master."""
    ck = str(tmp_path / "ck")
    sgd = TOpt(name="sgd")
    s1 = ElasticSession(_spec(
        elastic=dict(num_workers=4, membership_scenario="scale_down",
                     membership_k=2, membership_round=2), save_path=ck,
        optimizer=sgd))
    s1.run()
    assert s1.active_mask.tolist() == [True, True, False, False]
    s2 = ElasticSession(_spec(elastic=dict(num_workers=2, capacity=8),
                              rounds=6, rounds_per_call=2, seed=2,
                              optimizer=sgd))
    meta = s2.restore(ck)
    assert meta["elastic"]["capacity"] == 4
    assert meta["elastic"]["active"] == [1, 1, 0, 0]
    assert torch.equal(s2.state["master"], s1.state["master"])
    assert torch.equal(s2.state["workers"],
                       s1.state["master"].expand(8, -1))
    assert torch.equal(s2.state["u_hist"][:2], s1.state["u_hist"][:2])
    assert (s2.state["u_hist"][2:] == -30.0).all()
    s2.run(2)
    with pytest.warns(DeprecationWarning):
        s2.resize(6)
    recs = s2.run()
    assert [r.num_active for r in recs] == [6, 6, 6, 6]
    assert all(np.isfinite(r.loss) for r in recs)


MEMBERSHIP = [
    dict(membership_scenario="static", capacity=6),
    dict(membership_scenario="scale_up", capacity=6, membership_round=3),
    dict(membership_scenario="scale_down", membership_k=1),
    dict(membership_scenario="preempt_rejoin", membership_k=2,
         membership_round=1, crash_downtime=2),
    dict(membership_scenario="plan", capacity=6,
         membership_plan=((1, 2), (3, 5))),
]


@pytest.mark.parametrize("kw", MEMBERSHIP,
                         ids=[m["membership_scenario"] for m in MEMBERSHIP])
def test_session_membership_rows_match_reference(kw):
    """The port's session derives the reference session's membership and
    join rows, chunks at the same rounds, and re-partitions the data to
    the same batches at every transition (no round is trained)."""
    rounds = 6
    common = dict(num_workers=4, tau=1, failure_prob=0.3, **kw)
    data = dict(rounds=rounds, rounds_per_call=4, batch_size=4, n_data=96,
                n_test=16, seed=1)
    ref = RSession(RSpec(optimizer=ROpt(name="sgd"),
                         elastic=RElastic(**common), **data))
    port = ElasticSession(RunSpec(optimizer=TOpt(name="sgd"),
                                  elastic=TElastic(**common), device="cpu",
                                  **data))
    np.testing.assert_array_equal(port.schedule.active, ref.schedule.active)
    np.testing.assert_array_equal(port.schedule.joins(),
                                  ref.schedule.joins())
    for r in range(rounds):
        ref.round = port.round = r
        assert port._next_chunk(rounds) == ref._next_chunk(rounds)
        row = ref.schedule.active[r]
        ref._apply_membership(row)
        port._apply_membership(row)
        assert port.batcher.active == ref.batcher.active
        want, got = ref.batcher.round_batches(), port.batcher.round_batches()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_batcher_set_active_mask_matches_reference():
    ds = SyntheticImages(n=120, n_test=8, seed=3)
    kw = dict(num_workers=3, capacity=5, tau=2, overlap_ratio=0.25)
    rb = RBatcher(ds.images, ds.labels, RElastic(**kw), batch_size=4, seed=2)
    tb = TBatcher(ds.images, ds.labels, TElastic(**kw), batch_size=4, seed=2)
    for mask in ([1, 0, 1, 1, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 1]):
        rb.set_active_mask(np.asarray(mask, bool))
        tb.set_active_mask(np.asarray(mask, bool))
        assert tb.active == rb.active
        want, got = rb.round_batches(), tb.round_batches()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_u_zclip_statistics_cover_the_live_pool_only(seed):
    """``weights_for`` with the (k,) u of a capacity-padded pool and its
    live mask refuses the reference's workers: the robust z-scores are
    taken over the live slots, a vacant slot's u left out."""
    from repro.core import dynamic_weight as rdw
    from repro_torch.core import dynamic_weight as tdw

    rng = np.random.default_rng(seed)
    u = rng.normal(0.0, 0.5, 8).astype(np.float32)
    u[5] += 4.0  # one live outlier
    u[7] = 40.0  # a vacant slot far off, which must not move the pool
    a = rng.normal(0.0, 0.05, 8).astype(np.float32)
    live = np.arange(8) != 7
    kw = dict(num_workers=7, capacity=8, dynamic=True, u_zclip=3.0)
    want = rdw.weights_for(RElastic(**kw), jnp.asarray(a),
                           u=jnp.asarray(u), live=jnp.asarray(live))
    got = tdw.weights_for(TElastic(**kw), torch.from_numpy(a),
                          u=torch.from_numpy(u), live=torch.from_numpy(live))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1][5] == 0.0 and got[1][0] > 0.0
