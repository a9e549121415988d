"""Closed-loop control in the port against the JAX reference, on the CPU.

``repro_torch.control`` is a numpy copy of ``repro.control``: on identical
record streams its detector gives the reference's verdicts and events
round by round, and its policy and actuator the reference's actions —
checked on the reference's own synthetic ``FakeRecord`` streams
(tests/test_control.py) and on the record stream of one reference
session. The session's control surface (``apply`` evict/readmit, the
deprecated wrappers, observer hooks, the detector-blind echo) runs in the
port. Last, a closed-loop run: the same seeded run under
``crash_restart`` with the rule controller, in both packages, with the
reference's initial params carried into the port, gives the same journal
of applied actions. It runs momentum workers with dynamic weighting
(EAMSGD's optimizer, DEAHES-O's weights): they draw no probes, so the
run is the reference's to float32 reassociation, and in 10 rounds the
controller evicts twice and readmits once; AdaHessian with injected
probes under changing membership is held to the reference in
tests/test_torch_parity_membership_*.py.

The detector's round-level wall-time gate reads ``round_ms``, which no two
runs share; the closed-loop and record-stream checks zero it in the
records the controllers see, in both packages alike, so the decisions
rest on the diagnostics alone.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from repro.api import ElasticSession as RSession
from repro.api import RunSpec as RSpec
from repro.configs.base import ElasticConfig as RElastic
from repro.configs.base import OptimizerConfig as ROpt
from repro.control import detector as rdet
from repro.control import policy as rpol
from repro_torch.api import (ControlAction, ElasticSession, RunSpec,
                             SessionObserver)
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.control import actions as tact
from repro_torch.control import detector as tdet
from repro_torch.control import policy as tpol
from repro_torch.control.actuator import RuleController
from test_control import FakeRecord, healthy_then_adrift
from test_torch_session import (_reference_params,
                                one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# the copies on identical record streams
# ---------------------------------------------------------------------------

def _stream_adrift():
    return healthy_then_adrift(10, 4, slot=2, onset=4), None, None


def _stream_silent():
    return healthy_then_adrift(10, 4, slot=1, onset=3, drift=0.0), None, None


def _stream_noisy_round():
    u = healthy_then_adrift(12, 4, slot=0, onset=99, seed=3)
    u[6, 0] = u[5, 0] + 0.001
    u[7::2, 0] = u[6, 0] + 0.4
    u[8::2, 0] = u[6, 0]
    return u, None, None


def _stream_dark_then_back():
    """Slot 2 drifts, is evicted for six rounds (its telemetry frozen),
    then rejoins with a huge re-seat jump."""
    u = healthy_then_adrift(18, 4, slot=2, onset=3)
    act = np.ones((18, 4), bool)
    act[8:14, 2] = False
    u[8:14, 2] = u[7, 2]
    u[14, 2] = u[13, 2] - 5.0
    return u, act, None


def _stream_laggard():
    rng = np.random.default_rng(9)
    u, loss = np.zeros((14, 4)), np.ones((14, 4))
    for r in range(1, 14):
        u[r] = 2.0 + 0.3 * rng.choice([-1.0, 1.0], size=4)
        loss[r] = 1.0 + 0.02 * rng.standard_normal(4)
        u[r, 3] = -1.5 + 0.3 * rng.choice([-1.0, 1.0])
        loss[r, 3] = 2.5
    return u, None, loss


def _stream_random():
    """Random walks with a pool that changes under them."""
    rng = np.random.default_rng(5)
    u = np.cumsum(rng.normal(0.0, 0.3, (20, 6)), axis=0)
    act = rng.random((20, 6)) < 0.8
    act[:, 0] = True
    loss = 2.0 + rng.normal(0.0, 0.3, (20, 6))
    return u, act, loss


STREAMS = {f.__name__[8:]: f for f in (
    _stream_adrift, _stream_silent, _stream_noisy_round,
    _stream_dark_then_back, _stream_laggard, _stream_random)}


def _records(u, act, loss, round_ms=None):
    k = u.shape[1]
    return [FakeRecord(
        round=r, u=np.asarray(u[r], float),
        active=np.ones(k, bool) if act is None else act[r],
        loss_w=None if loss is None else np.asarray(loss[r], float),
        round_ms=0.0 if round_ms is None else round_ms[r])
        for r in range(len(u))]


def _drive(det_mod, pol_mod, records, det_cfg=None, **pol_kw):
    """Feed ``records`` to a detector and, after every round, ask a policy
    for actions on the verdicts: the per-round verdicts, the events and
    the actions as plain values."""
    cfg = det_cfg and det_mod.DetectorConfig(**det_cfg)
    det = det_mod.FailureDetector(records[0].u.shape[0], cfg)
    pol = pol_mod.RulePolicy(pol_mod.PolicyConfig(**pol_kw))
    verdicts, actions = [], []
    for rec in records:
        det.observe(rec)
        verdicts.append(det.verdicts())
        actions.append([(a.kind, a.slots, a.k, a.reason) for a in
                        pol.decide(det.verdicts(), rec.active, rec.round)])
    return verdicts, det.events, actions


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("det_cfg", [None, dict(slow_z=2.0, slow_loss_z=2.0)])
def test_detector_and_policy_match_reference(name, det_cfg):
    u, act, loss = STREAMS[name]()
    ms = 100.0 + 10.0 * np.sin(np.arange(len(u)))
    ms[len(u) // 2] = 900.0  # one wall-time outlier round
    recs = _records(u, act, loss, ms)
    want = _drive(rdet, rpol, recs, det_cfg, min_pool=1)
    got = _drive(tdet, tpol, recs, det_cfg, min_pool=1)
    assert got == want
    if name in ("adrift", "silent"):
        assert any(v == tdet.FAILED_SUSPECT for _, _, v in got[1])


def test_actions_and_verdict_names_match_reference():
    from repro.control import actions as ract

    assert tact.ACTION_KINDS == ract.ACTION_KINDS
    assert tdet.VERDICTS == rdet.VERDICTS
    assert tdet.DetectorConfig() == tdet.DetectorConfig(
        **dataclasses.asdict(rdet.DetectorConfig()))
    assert dataclasses.asdict(tpol.PolicyConfig()) == dataclasses.asdict(
        rpol.PolicyConfig())
    for make in (lambda m: m.ControlAction.evict([2, 0], reason="x"),
                 lambda m: m.ControlAction.readmit([1]),
                 lambda m: m.ControlAction.resize(3),
                 lambda m: m.ControlAction.set_membership([1, 0, 1]),
                 lambda m: m.ControlAction.noop("all healthy")):
        assert make(tact).describe() == make(ract).describe()
    for bad in (lambda m: m.ControlAction.evict([]),
                lambda m: m.ControlAction("resize"),
                lambda m: m.ControlAction("transmogrify")):
        with pytest.raises(ValueError):
            bad(tact)


# ---------------------------------------------------------------------------
# the session's control surface
# ---------------------------------------------------------------------------

def _spec(**kw):
    kw.setdefault("elastic", TElastic(num_workers=2, capacity=4, tau=1,
                                      alpha=0.1))
    kw.setdefault("rounds", 3)
    return RunSpec(optimizer=TOpt(name="sgd", lr=0.01), batch_size=4,
                   n_data=64, n_test=32, device="cpu", **kw)


def test_runspec_validation_as_reference():
    for mod in (RSpec, RunSpec):
        with pytest.raises(ValueError, match="controller"):
            mod(controller="nope")
        with pytest.raises(ValueError, match="plain"):
            mod(plain=True, controller="rules")
    with pytest.raises(ValueError, match="oracle"):
        RunSpec(detector_blind=True,
                elastic=TElastic(num_workers=2, oracle=True))


def test_apply_evict_readmit_roundtrip_and_wrappers():
    sess = ElasticSession(_spec(rounds=5))
    sess.run(1)
    with pytest.raises(TypeError, match="ControlAction"):
        sess.apply("evict 2")
    with pytest.raises(ValueError, match="vacant"):
        sess.apply(ControlAction.evict([3]))
    with pytest.raises(ValueError, match="live"):
        sess.apply(ControlAction.readmit([0]))
    sess.apply(ControlAction.readmit([2]))
    sess.apply(ControlAction.evict([0]))
    assert sess.active_mask.tolist() == [False, True, True, False]
    frozen = sess.state["workers"][0].clone()
    recs = sess.run(2)
    assert [r.active.tolist() for r in recs] == [[False, True, True,
                                                  False]] * 2
    assert torch.equal(sess.state["workers"][0], frozen)
    assert all(r.h2[0] == 0 and r.u[0] == 0 for r in recs)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sess.resize(3)
        assert sess.active_mask.tolist() == [True, True, True, False]
        sess.set_membership([True, False, False, True])
        assert sess.num_active == 2
    assert [x.category for x in w] == [DeprecationWarning] * 2
    sess.apply(ControlAction.noop())
    sess.run()
    with pytest.raises(ValueError, match="complete"):
        sess.apply(ControlAction.resize(2))


def test_observer_hooks_fire_between_chunks():
    seen = {"rounds": [], "chunks": []}

    class Obs:
        def on_round(self, record):
            seen["rounds"].append(record.round)

        def on_chunk_end(self, session):
            seen["chunks"].append(session.round)

    assert isinstance(Obs(), SessionObserver)
    sess = ElasticSession(_spec(rounds=4, rounds_per_call=2))
    sess.add_observer(Obs())
    sess.run()
    assert seen == {"rounds": [0, 1, 2, 3], "chunks": [2, 4]}


def test_detector_blind_echo_is_zeroed_and_bit_exact():
    ec = TElastic(num_workers=2, tau=1, failure_prob=0.5,
                  failure_scenario="crash_restart")
    open_sess = ElasticSession(_spec(elastic=ec))
    blind_sess = ElasticSession(_spec(elastic=ec, detector_blind=True))
    open_recs, blind_recs = open_sess.run(), blind_sess.run()
    assert any(r.fail.any() for r in open_recs)
    for rec in blind_recs:
        assert not (rec.fail.any() or rec.straggle.any()
                    or rec.restart.any() or rec.corrupt.any())
    for a, b in zip(open_recs, blind_recs):
        np.testing.assert_array_equal(a.u, b.u)
        np.testing.assert_array_equal(a.h2, b.h2)
    assert torch.equal(open_sess.state["master"], blind_sess.state["master"])


# ---------------------------------------------------------------------------
# a closed-loop run in both packages
# ---------------------------------------------------------------------------

def _cl_kw():
    ekw = dict(num_workers=4, tau=1, alpha=0.1, overlap_ratio=0.25,
               dynamic=True, failure_scenario="crash_restart")
    return ekw, dict(rounds=10, seed=0, batch_size=8, n_data=400,
                     n_test=32, controller="rules")


def _blind_to_time(controller):
    """Zero ``round_ms`` in what ``controller``'s detector observes."""
    observe = controller.detector.observe
    controller.detector.observe = lambda rec: observe(
        dataclasses.replace(rec, round_ms=0.0))


@functools.lru_cache(maxsize=None)
def _reference_closed_loop():
    ekw, kw = _cl_kw()
    sess = RSession(RSpec(optimizer=ROpt(name="momentum", lr=0.01),
                          elastic=RElastic(**ekw), **kw))
    _blind_to_time(sess.controller)
    records = sess.run()
    return sess, records


def _journal(sess):
    return [(a.round, a.action.kind, a.action.slots, a.applied,
             a.live_after, a.note) for a in sess.controller.actuator.log]


def test_closed_loop_journal_matches_reference():
    """Crash-restart at k=4 under the rule controller, 10 rounds, the
    reference's initial params: the port's detector events, its applied
    actions (evictions and a readmission) and the live mask of every
    round are the reference's."""
    ref, ref_recs = _reference_closed_loop()
    ekw, kw = _cl_kw()
    sess = ElasticSession(
        RunSpec(optimizer=TOpt(name="momentum", lr=0.01),
                elastic=TElastic(**ekw), device="cpu", **kw),
        params=_reference_params())
    assert isinstance(sess.controller, RuleController)
    _blind_to_time(sess.controller)
    recs = sess.run()
    kinds = {a.action.kind for a in ref.controller.actuator.log
             if a.applied}
    assert kinds == {"evict", "readmit"}, kinds
    assert _journal(sess) == _journal(ref)
    assert sess.controller.detector.events == ref.controller.detector.events
    for a, b in zip(recs, ref_recs):
        np.testing.assert_array_equal(a.active, b.active)
    # after every applied action the live mask is what the action says
    for entry in sess.controller.actuator.log:
        if entry.applied and entry.action.kind in ("evict", "readmit"):
            row = recs[entry.round].active
            assert row[list(entry.action.slots)].all() == (
                entry.action.kind == "readmit")


def test_reference_record_stream_drives_the_copies_alike():
    """The records of the reference's closed-loop run, fed to a fresh
    detector and policy of each package, give the same verdicts, events
    and actions round by round."""
    _, recs = _reference_closed_loop()
    recs = [dataclasses.replace(r, round_ms=0.0) for r in recs]
    assert _drive(tdet, tpol, recs) == _drive(rdet, rpol, recs)
