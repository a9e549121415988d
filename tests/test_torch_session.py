"""The port's trainer and session against the JAX reference, and against
itself.

``run_parity`` is the per-round state-parity harness the
``test_torch_parity_*`` files drive: the reference ``ElasticTrainer``
(plain path, ``use_pallas=False``) and the port's trainer on
``device="cpu"`` start from the same carried state, eat the same batches
and schedule masks, and the port's probe seam is fed the reference's own
Rademacher probes, rebuilt from the reference's key chain
(``fold_in(key(seed), r)`` → ``split(·, τ)`` → ``split(·, k)`` →
``rademacher_like``; ``repro/core/coordinator.py`` local phase). After
every round the full state — workers, optimizer counts and moments,
master, master_prev, u-history, round — and the round's diagnostics must
agree.

Tolerance. The round's diagnostics (u, score, h1, h2, loss, loss_w) and
the u-history are held to rtol 1e-4, atol 1e-5: float32 reductions
(matmuls, norms, sums) reassociate differently in XLA and PyTorch. The
state is compared per leaf (a parameter leaf over workers, master and
master_prev together, so the master's small cancelling biases are scaled
by the workers') in two ways: norm-wise, ||got - want||_2 <= 1e-3
||want||_2, and elementwise, rtol 1e-4 with an atol of 2% of the leaf's
largest magnitude. The elementwise bound is loose because the network is
piecewise: when two conv2 outputs in a 2x2 max-pool window are within a
few ulps, reassociation can swap the winner. The gradient barely moves,
but the Hutchinson product for that pooled feature then runs through the
other position's receptive field, so AdaHessian's second moment for one
fc1 row changes by O(1) (measured: 4 of 36,864 rows in one round at k=4,
v off by up to 44%) and that row's step with it — 0.7% of fc1's scale
after three rounds. Norm-wise such rows are invisible; the worst leaf
over the whole matrix measured 1.9e-4 on the CPU. A rounding-free fault
(a missing elastic pull, a wrong weight) moves every element of a leaf
and fails the norm-wise bound.
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
from repro.experiments import paper_repro as rpaper
from repro.models.cnn import PaperCNN as RCNN
from repro.nn.param import init_tree as rinit_tree
from repro.optim.hutchinson import rademacher_like
from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import get_config as tget
from repro_torch.core.coordinator import ElasticTrainer as TTrainer
from repro_torch.core.coordinator import RoundInputs as TInputs
from repro_torch.core.scenarios import ScenarioSchedule
from repro_torch.experiments import paper_repro as tpaper
from repro_torch.models.cnn import PaperCNN as TCNN
from repro_torch.nn.param import init_tree, tree_leaves

@pytest.fixture
def one_torch_thread():
    """One intra-op torch thread for the test. The suite runs six xdist
    workers on the CPU's cores; torch's default of one thread per core in
    each of them oversubscribes the cores, and a small torch workload then
    runs many times slower than alone (measured: 5 s alone, 125 s in the
    six-worker run, for ``test_session_runs_the_features_this_slice_ported``).
    Results do not depend on it beyond float reassociation, which every
    comparison across packages tolerates."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-4, 1e-5            # diagnostics and u-history
NORM_RTOL, ELEM_ATOL_FRAC = 1e-3, 2e-2  # state, per leaf
PARAMS = ("workers", "master", "master_prev")
SEED, ROUNDS, TAU, BATCH = 0, 3, 2, 2


def _configs(method, k, comm):
    opt, dynamic, oracle, overlap = rpaper.METHODS[method]
    ekw = dict(num_workers=k, tau=TAU, alpha=rpaper.ALPHA,
               overlap_ratio=rpaper.paper_overlap_ratio(k) if overlap else 0.0,
               dynamic=dynamic, oracle=oracle, comm_mode=comm)
    okw = dict(name=opt, lr=rpaper.LR, momentum=0.5, betas=(0.9, 0.999))
    return ekw, okw


@functools.lru_cache(maxsize=None)
def _initial_params():
    """Initial params in the reference layout, drawn by the port's
    fan-in init (the reference's own rule; jax's eager threefry over 1.2M
    parameters takes seconds) and carried into the reference's
    ``init_state``."""
    spec = TCNN(tget("paper-cnn")).spec
    return jax.tree.map(lambda t: t.numpy(), init_tree(
        torch.Generator().manual_seed(SEED), spec))


@functools.lru_cache(maxsize=None)
def _reference_params():
    """The reference's own init for ``seed``, as its ``run_one`` draws it."""
    model = RCNN(rget("paper-cnn"))
    return jax.device_get(jax.jit(lambda key: rinit_tree(key, model.spec))(
        jax.random.key(SEED)))


@functools.lru_cache(maxsize=None)
def _reference(method, k, comm):
    """One jitted reference trainer per (method, k, comm mode), shared by
    both scenarios (the scenario only changes the masks fed in), and its
    initial state."""
    ekw, okw = _configs(method, k, comm)
    model = RCNN(rget("paper-cnn"))
    trainer = RTrainer(model, ROpt(**okw), RElastic(**ekw))
    state0 = jax.device_get(trainer.init_state(jax.random.key(SEED),
                                               params=_initial_params()))
    return trainer, state0


@functools.lru_cache(maxsize=None)
def _worker_probe():
    """Jitted key -> one worker's flat (n,) probe, ``rademacher_like`` as
    the reference's local phase calls it (compiled once per process)."""
    like = _initial_params()
    return jax.jit(lambda key: jnp.concatenate(
        [x.reshape(-1) for x in jax.tree.leaves(rademacher_like(key, like))]))


def _round_probes(rng, k):
    """(τ, k, n) probes of one round in the reference's key chain."""
    one = _worker_probe()
    return np.stack([np.stack([np.asarray(one(key))
                               for key in jax.random.split(rt, k)])
                     for rt in jax.random.split(rng, TAU)])


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _leaf_close(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want)
    if (d > RTOL * np.abs(want) + ELEM_ATOL_FRAC * np.abs(want).max()).any():
        np.testing.assert_allclose(  # fails, with numpy's report
            got, want, rtol=RTOL, atol=ELEM_ATOL_FRAC * np.abs(want).max(),
            err_msg=msg)
    err, ref = np.linalg.norm(d), np.linalg.norm(want)
    assert err <= NORM_RTOL * ref, f"{msg}: |d|/|want| = {err / ref:.2e}"


def _assert_state_close(got, want, msg):
    for path, _ in tree_leaves(want["master"]):
        stack = lambda s: np.concatenate(
            [np.ravel(dict(tree_leaves(s[e]))[path]) for e in PARAMS])
        _leaf_close(stack(got), stack(want), f"{msg} params/{path}")
    assert set(got["opt"]) == set(want["opt"])
    np.testing.assert_array_equal(got["opt"]["count"], want["opt"]["count"])
    for key in set(want["opt"]) - {"count"}:
        for path, leaf in tree_leaves(want["opt"][key]):
            _leaf_close(dict(tree_leaves(got["opt"][key]))[path], leaf,
                        f"{msg} opt/{key}/{path}")
    _close(got["u_hist"], want["u_hist"], f"{msg} u_hist")
    assert int(got["round"]) == int(want["round"])


def run_parity(method, k, comm, scenario, placement="single"):
    """``placement="sharded"`` runs the port's sharded code at world size
    1 (no process group) against the reference's single placement."""
    rtrainer, state0 = _reference(method, k, comm)
    ekw, okw = _configs(method, k, comm)
    probes = {}
    ttrainer = TTrainer(TCNN(tget("paper-cnn")), TOpt(**okw),
                        TElastic(**ekw, placement=placement), device="cpu",
                        probe_fn=lambda r, t, i: probes[r][t, i][None])
    tstate = ttrainer.state_from_numpy(state0)
    rstate = jax.tree.map(jnp.asarray, state0)
    ds = SyntheticImages(n=256, n_test=8, seed=1)
    batcher = WorkerBatcher(ds.images, ds.labels, RElastic(**ekw),
                            batch_size=BATCH, seed=SEED)
    # one-round outages, so a crash and its restart fit in ROUNDS rounds
    sched = make_scenario(RElastic(**ekw, failure_scenario=scenario,
                                   crash_downtime=1)
                          ).schedule(SEED + 7, ROUNDS, k)
    failed_recent = sched.failed_recent_all()
    assert scenario != "crash_restart" or sched.restart[1:].any()
    for r in range(ROUNDS):
        b = batcher.round_batches()
        rng = jax.random.fold_in(jax.random.key(SEED), r)
        # restart always passed (all-False under iid): one trace per trainer
        rstate, rmet = rtrainer.round_step(rstate, RInputs(
            batches={key: jnp.asarray(v) for key, v in b.items()}, rng=rng,
            fail=jnp.asarray(sched.fail[r]),
            failed_recent=jnp.asarray(failed_recent[r]),
            restart=jnp.asarray(sched.restart[r])))
        if okw["name"] == "adahessian":
            probes[r] = torch.from_numpy(_round_probes(rng, k))
        tstate, tmet = ttrainer.round_step(tstate, TInputs(
            batches={"images": torch.from_numpy(b["images"]),
                     "labels": torch.from_numpy(b["labels"]).long()},
            round=r, fail=sched.fail[r], failed_recent=failed_recent[r],
            restart=sched.restart[r] if sched.has_restarts else None))
        _assert_state_close(ttrainer.state_to_numpy(tstate),
                            jax.device_get(rstate), f"round {r}")
        for key, want in jax.device_get(rmet).items():
            _close(tmet[key].numpy(), want, f"round {r} metric {key}")


# ---------------------------------------------------------------------------
# port-internal: sequential vs fused, chunked vs per-round
# ---------------------------------------------------------------------------

def _spec(**kw):
    ekw = dict(num_workers=3, tau=2, dynamic=False, alpha=0.2)
    ekw.update(kw.pop("elastic", {}))
    base = dict(optimizer=TOpt(name="adahessian"), elastic=TElastic(**ekw),
                rounds=3, batch_size=4, n_data=200, n_test=16, device="cpu",
                eval_every=1)
    base.update(kw)
    return RunSpec(**base)


def _run_masters(spec):
    sess = ElasticSession(spec)
    records = sess.run()
    return sess.state["master"].clone(), records


def _clone(state):
    return {key: ({k: v.clone() for k, v in val.items()}
                  if isinstance(val, dict) else
                  val.clone() if isinstance(val, torch.Tensor) else val)
            for key, val in state.items()}


@pytest.fixture(scope="module")
def desynced():
    """A 4-worker session two rounds in: workers apart from the master."""
    sess = ElasticSession(_spec(elastic=dict(num_workers=4)))
    sess.run(2)
    return sess


@pytest.mark.parametrize("fail", [[False] * 4, [False, True, False, True]])
@pytest.mark.parametrize("straggle", [None, [True, False, False, True]])
def test_sequential_and_fused_masters_equal_when_h2_agree(desynced, fail,
                                                          straggle):
    """Fixed α from one desynced state: every syncing worker has h2 = α in
    both modes, and the fused weights g_i = α·Π_{j>i}(1−α) reproduce the
    sequential scan's master — up to the reassociation of the batched sum
    (rtol 1e-5, atol 1e-6: the reference's bar, tests/test_comm_fused.py).
    Suppressed workers exchange nothing in either mode."""
    sess = desynced
    fail = np.asarray(fail)
    straggle = None if straggle is None else np.asarray(straggle)
    out = {}
    for comm in ("sequential", "fused"):
        trainer = TTrainer(sess.model, sess.spec.optimizer,
                           TElastic(num_workers=4, tau=2, dynamic=False,
                                    alpha=0.2, comm_mode=comm),
                           device="cpu")
        state = _clone(sess.state)
        out[comm] = state, trainer.comm_phase(state, fail, straggle=straggle)
    (ss, ms), (sf, mf) = out["sequential"], out["fused"]
    for key in ("h1", "h2"):
        torch.testing.assert_close(ms[key], mf[key], rtol=0, atol=0)
    torch.testing.assert_close(sf["master"], ss["master"], rtol=1e-5,
                               atol=1e-6)
    for i in np.flatnonzero(fail):
        assert ms["h2"][i] == 0 and mf["h1"][i] == 0
        assert torch.equal(ss["workers"][i], sess.state["workers"][i])
        assert torch.equal(sf["workers"][i], sess.state["workers"][i])
    for state in (ss, sf):  # master_prev is the round-start master
        assert torch.equal(state["master_prev"], sess.state["master"])
        assert state["round"] == sess.state["round"] + 1


@pytest.mark.parametrize("comm", ["sequential", "fused"])
def test_rounds_per_call_equals_per_round(comm):
    kw = dict(elastic=dict(num_workers=2, tau=1, comm_mode=comm,
                           dynamic=True), rounds=4, eval_every=3)
    per_round, recs1 = _run_masters(_spec(**kw))
    chunked, recs3 = _run_masters(_spec(rounds_per_call=3, **kw))
    assert torch.equal(per_round, chunked)
    assert [r.loss for r in recs1] == [r.loss for r in recs3]
    assert [r.eval_acc for r in recs1] == [r.eval_acc for r in recs3]


def test_all_six_methods_run_through_run_one():
    for method in tpaper.METHODS:
        res = tpaper.run_one(method, 2, 1, rounds=2, batch_size=4,
                             n_data=120, n_test=16, eval_every=1,
                             device="cpu")
        assert res["device"] == "cpu" and len(res["round_ms"]) == 2
        assert np.isfinite(res["curves"]["train_loss"]).all(), method
        assert 0.0 <= res["final_acc"] <= 1.0


@pytest.mark.parametrize("method", ["EASGD", "EAMSGD"])
def test_first_order_curves_match_reference_run_one(method):
    """EASGD/EAMSGD draw no probes, so with the reference's initial params
    carried across the whole §VI run — data, overlap, schedule, eval — is
    the reference's, to float32 reassociation."""
    kw = dict(rounds=4, batch_size=4, n_data=160, n_test=24, eval_every=2)
    want = rpaper.run_one(method, 2, 2, **kw)
    got = tpaper.run_one(method, 2, 2, device="cpu",
                         params=_reference_params(), **kw)
    assert got["curves"]["round"] == want["curves"]["round"]
    for key in ("train_loss", "test_loss", "test_acc", "h2"):
        _close(got["curves"][key], want["curves"][key], key)


def test_session_refuses_unported_features_by_name():
    """The model families the port lacks still raise naming themselves
    (an arch outside ``PORTED_ARCHS``, an MoE config). Membership
    (capacity, an ``active`` schedule), the rule controller,
    ``detector_blind``, ``apply``, hierarchy, sharded placement and LM
    training on the dense family have since been ported: they now
    construct (tests/test_torch_membership.py,
    tests/test_torch_control.py, tests/test_torch_hierarchy.py,
    tests/test_torch_placement.py, tests/test_torch_distributed.py and
    tests/test_torch_lm_session.py run them); with no process group,
    sharded placement runs at world size 1."""
    hier = ElasticSession(_spec(elastic=dict(groups=3, comm_mode="fused")))
    assert hier.trainer._n_groups == 3
    assert hier.state["submasters"].shape == (3, hier.layout.n)
    hier = ElasticSession(_spec(elastic=dict(global_period=2,
                                             comm_mode="fused")))
    assert hier.trainer._hier and hier.trainer._n_groups == 1
    for extra in ({}, {"groups": 3}):
        sharded = ElasticSession(_spec(elastic=dict(
            placement="sharded", comm_mode="fused", **extra)))
        assert sharded.trainer._world == 1 and sharded.capacity == 3
        assert sharded.state["workers"].shape == (3, sharded.layout.n)
    lm = ElasticSession(_spec(model_cfg=tget("qwen3-4b", smoke=True),
                              seq_len=16, n_tokens=2000))
    assert lm.state["workers"].shape == (3, lm.layout.n)
    assert sorted(lm._test) == ["targets", "tokens"]
    for arch in ("rwkv6-3b", "zamba2-7b"):
        with pytest.raises(NotImplementedError, match=arch):
            ElasticSession(_spec(arch=arch, smoke=True))
    # an encoder-decoder trains on source frames the LM data lacks; a VLM
    # trains text-only, as the reference's session feeds it
    with pytest.raises(NotImplementedError, match="seamless-smoke.*'src'"):
        ElasticSession(_spec(arch="seamless-m4t-large-v2", smoke=True))
    vlm = ElasticSession(_spec(arch="qwen2-vl-7b", smoke=True, seq_len=16,
                               n_tokens=2000))
    assert type(vlm.model).__name__ == "VLM"
    assert sorted(vlm._test) == ["targets", "tokens"]
    moe = ElasticSession(_spec(arch="mixtral-8x22b", smoke=True,
                               seq_len=16, n_tokens=2000))
    assert moe.model.n_moe == 2 and "moe_layers.moe.router" in \
        moe.layout.names
    with pytest.raises(ValueError, match="seq_len"):
        _spec(seq_len=0)
    with pytest.raises(ValueError, match="n_tokens"):
        _spec(n_tokens=0)
    assert ElasticSession(_spec(elastic=dict(capacity=4))).capacity == 4
    assert ElasticSession(_spec(controller="rules")).controller is not None
    z = np.zeros((3, 3), bool)
    sess = ElasticSession(_spec(schedule=ScenarioSchedule(
        z, z, z, active=np.array([[1, 1, 0]] * 3, bool)),
        detector_blind=True))
    assert sess.active_mask.tolist() == [True, True, False]
    with pytest.raises(TypeError, match="ControlAction"):
        sess.apply(None)
    assert [n for n, _ in tree_leaves(sess.model.spec)][0] == ("conv1", "b")


@pytest.mark.usefixtures("one_torch_thread")
def test_session_runs_the_features_this_slice_ported(tmp_path):
    """What the refusals above used to cover now runs: the byzantine and
    hetero channels, plain mode, ``save`` and ``RunSpec.save_path``
    (their parity with the reference: tests/test_torch_adversarial*.py,
    tests/test_torch_plain.py, tests/test_torch_checkpoint.py)."""
    for scenario in ("byzantine", "hetero"):
        sess = ElasticSession(_spec(elastic=dict(
            failure_scenario=scenario, byzantine_frac=0.5)))
        assert all(np.isfinite(r.loss) for r in sess.run())
        assert sess.save(str(tmp_path / scenario)) == str(tmp_path / scenario)
    path = str(tmp_path / "plain")
    sess = ElasticSession(_spec(plain=True, save_path=path))
    assert [r.round for r in sess.run()] == [0, 1, 2]
    assert tck.read_metadata(path)["scenario"] == "none"
