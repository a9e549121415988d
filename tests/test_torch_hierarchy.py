"""Hierarchical averaging (tree-EASGD) in the port against the JAX reference.

The port's rack helpers, grouped exchange and hierarchical comm phase are
held to ``src/repro`` on the same numpy-seeded inputs (the session and
checkpoints: tests/test_torch_hierarchy_session.py):

- ``group_assignment`` exactly, ``master_schedule_weights_grouped`` to
  rtol 1e-6 (a float32 product of up to 16 factors, which XLA and PyTorch
  may multiply in another order; the reference's own test holds its
  weights to the sequential unroll at that bar);
- the plain grouped exchange at rtol 1e-5, atol 1e-6 (the fused-comm bar
  of tests/test_comm_fused.py: the reference reduces a rack in another
  order);
- the comm phase alone over four rounds from one desynced state, state at
  rtol 1e-5 / atol 1e-6 and the eight diagnostics at rtol 1e-4 / atol 1e-5
  (tests/test_torch_session.py's diagnostics bar: log, sqrt and the
  robust z-score reassociate);
- inside the port, the forced degenerate topology (one rack, period 1)
  bit for bit against the flat fused round.
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
from repro.core import dynamic_weight as rdw
from repro.core import elastic as relastic
from repro.core.coordinator import ElasticTrainer as RTrainer
from repro.models.cnn import PaperCNN as RCNN
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import get_config as tget
from repro_torch.core import dynamic_weight as tdw
from repro_torch.core import elastic as telastic
from repro_torch.core.coordinator import ElasticTrainer as TTrainer
from repro_torch.core.coordinator import RoundInputs as TInputs
from repro_torch.kernels.elastic import ops as tops
from repro_torch.models.cnn import PaperCNN as TCNN
from repro_torch.nn.param import init_tree, tree_leaves
from test_torch_session import SEED, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STATE_TOL = dict(rtol=1e-5, atol=1e-6)
DIAG_TOL = dict(rtol=1e-4, atol=1e-5)
DIAGS = ("u", "score", "h1", "h2", "g_u", "g_score", "g_h1", "g_h2")


def _leaves(tree):
    return [np.asarray(x) for _, x in tree_leaves(tree)]


def _assert_trees(got, want, exact=False, **tol):
    for (pg, g), (pw, w) in zip(tree_leaves(got), tree_leaves(want)):
        assert pg == pw
        if exact:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                       err_msg="/".join(pg))


# ---------------------------------------------------------------------------
# (a) rack map and grouped event-order weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", range(1, 18))
def test_group_assignment_and_grouped_weights_match_reference(cap):
    rng = np.random.default_rng(cap)
    for groups in range(1, cap + 1):
        grp = tdw.group_assignment(cap, groups)
        want = rdw.group_assignment(cap, groups)
        assert grp.dtype == want.dtype
        np.testing.assert_array_equal(grp, want)
        bounds = tdw.rack_bounds(grp, int(grp.max()) + 1)
        assert [e - s for s, e in bounds] == np.bincount(grp).tolist()
        w2 = rng.uniform(0.0, 0.4, cap).astype(np.float32)
        w2[rng.random(cap) < 0.3] = 0.0  # dead slots
        np.testing.assert_allclose(
            tdw.master_schedule_weights_grouped(torch.from_numpy(w2),
                                                grp).numpy(),
            np.asarray(rdw.master_schedule_weights_grouped(
                jnp.asarray(w2), jnp.asarray(grp))), rtol=1e-6, atol=0)


def test_rack_bounds_refuses_racks_that_are_not_contiguous():
    with pytest.raises(ValueError, match="contiguous"):
        tdw.rack_bounds(np.array([0, 1, 0]), 2)
    with pytest.raises(ValueError, match="contiguous"):
        tdw.rack_bounds(np.array([1, 1, 0]), 2)
    with pytest.raises(ValueError, match="contiguous"):
        tdw.rack_bounds(np.array([0, 0, 1]), 3)
    w, s = torch.zeros(3, 4), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tops.elastic_update_grouped(w, s, torch.zeros(2, 3),
                                    np.array([0, 1, 0]))


# ---------------------------------------------------------------------------
# (b) the plain grouped exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,groups", [(8, 2), (7, 3)])
def test_grouped_exchange_matches_reference(cap, groups):
    """Balanced (cap 8 over 2 racks: the reference's reshape path) and
    uneven (cap 7 over 3, racks of 3/2/2: its one-hot segment path). The
    port's wrapper on CPU tensors runs the same plain loop."""
    rng = np.random.default_rng(cap * 10 + groups)
    n = 1031
    grp = tdw.group_assignment(cap, groups)
    w = rng.standard_normal((cap, n)).astype(np.float32)
    sm = rng.standard_normal((groups, n)).astype(np.float32)
    w1 = rng.uniform(0, 1, cap).astype(np.float32)
    w2 = rng.uniform(0, 0.4, cap).astype(np.float32)
    w1[1] = w2[1] = 0.0
    g2 = np.asarray(rdw.master_schedule_weights_grouped(jnp.asarray(w2),
                                                        jnp.asarray(grp)))
    rw, rsm = relastic.elastic_update_grouped(
        {"p": jnp.asarray(w)}, {"p": jnp.asarray(sm)}, jnp.asarray(w1),
        jnp.asarray(g2), grp)
    h = torch.from_numpy(np.stack([w1, g2]))
    for fn in (telastic.elastic_update_grouped, tops.elastic_update_grouped):
        tw, tsm = torch.from_numpy(w.copy()), torch.from_numpy(sm.copy())
        fn(tw, tsm, h, grp)
        np.testing.assert_allclose(tw.numpy(), np.asarray(rw["p"]),
                                   **STATE_TOL)
        np.testing.assert_allclose(tsm.numpy(), np.asarray(rsm["p"]),
                                   **STATE_TOL)
        # a dead slot (h1 = h2 = 0) leaves its row bit-unchanged
        np.testing.assert_array_equal(tw[1].numpy(), w[1])


# ---------------------------------------------------------------------------
# (c) the hierarchical comm phase, four rounds
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params():
    spec = TCNN(tget("paper-cnn")).spec
    return jax.tree.map(lambda t: t.numpy(), init_tree(
        torch.Generator().manual_seed(SEED), spec))


def _trainers(ekw, hierarchical=None):
    opt = dict(name="sgd", lr=0.01)
    ref = RTrainer(RCNN(rget("paper-cnn")), ROpt(**opt), RElastic(**ekw))
    port = TTrainer(TCNN(tget("paper-cnn")), TOpt(**opt), TElastic(**ekw),
                    device="cpu", hierarchical=hierarchical)
    return ref, port


def _desynced(ref, seed, poison=None):
    """A reference state tree with workers and sub-masters moved off the
    master; the workers' u-histories scatter around the distances they
    measure (scores land on every branch of h1/h2), the racks' climb
    toward theirs (positive scores: a live rack that syncs gets h2 = α);
    ``poison`` slots hold +inf."""
    rng = np.random.default_rng(seed)
    st = jax.device_get(ref.init_state(jax.random.key(0), params=_params()))
    noise = lambda tree, s: jax.tree.map(
        lambda x: (x + s * rng.standard_normal(x.shape)).astype(np.float32),
        tree)
    st["workers"] = noise(st["workers"], 0.1)
    st["submasters"] = noise(st["submasters"], 0.05)
    if poison is not None:
        st["workers"] = jax.tree.map(
            lambda x: np.where(np.arange(x.shape[0]).reshape(
                (-1,) + (1,) * (x.ndim - 1)) == poison, np.inf, x)
            .astype(np.float32), st["workers"])
    st["u_hist"] = rng.normal(4.8, 0.3, st["u_hist"].shape).astype(np.float32)
    g, p = st["g_u_hist"].shape
    st["g_u_hist"] = (np.linspace(3.0, 3.5, p)[None]
                      + rng.normal(0, 0.01, (g, p))).astype(np.float32)
    return st


@pytest.mark.parametrize("cap,groups,clip", [(6, 2, False), (7, 3, False),
                                             (7, 3, True)])
def test_comm_phase_matches_reference(cap, groups, clip):
    """Four rounds at global period 2 (syncs after rounds 1 and 3): one
    worker fails in round 0; every member of rack 0 fails in round 1, a
    sync round, leaving it dark; the last rack is vacant in rounds 2-3,
    with one more failure in round 3. Between rounds the live workers
    drift by the same numpy noise in both packages, as a local phase would
    move them: a worker snapped onto its sub-master (h1 = 1) would
    otherwise sit at a rounding-level distance, whose log no two
    frameworks share. ``clip`` adds ``score_clip`` 4 and ``u_zclip`` 3
    with worker 1's params at +inf, re-seated to its rack's sub-master by
    the quarantine."""
    ekw = dict(num_workers=cap, tau=1, alpha=0.1, dynamic=True,
               comm_mode="fused", groups=groups, global_period=2)
    if clip:
        ekw.update(score_clip=4.0, u_zclip=3.0)
    ref, port = _trainers(ekw)
    st0 = _desynced(ref, cap * 10 + groups, poison=1 if clip else None)
    rstate = jax.tree.map(jnp.asarray, st0)
    tstate = port.state_from_numpy(st0)
    grp = port._grp
    none = np.zeros(cap, bool)
    last = grp == groups - 1
    fails = [np.arange(cap) == 2, grp == 0, none, np.arange(cap) == 0]
    actives = [None, None, ~last, ~last]
    fr = np.arange(cap) == cap - 2
    rng = np.random.default_rng(cap)
    for r in range(4):
        kw = {} if actives[r] is None else {"active": actives[r]}
        if r:
            live = np.ones(cap) if actives[r] is None else actives[r]
            drift = torch.from_numpy((0.01 * live[:, None] * rng.standard_normal(
                tstate["workers"].shape)).astype(np.float32))
            tstate["workers"] += drift
            rstate["workers"] = jax.tree.map(
                lambda w, d: w + jnp.asarray(d), rstate["workers"],
                port.layout.to_numpy(drift))
        rstate, rmet = ref.comm_phase(
            rstate, jnp.asarray(fails[r]), jnp.asarray(fr),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        tmet = port.comm_phase(tstate, fails[r], fr, **kw)
        got, want = port.state_to_numpy(tstate), jax.device_get(rstate)
        for key in ("workers", "master", "master_prev", "submasters"):
            _assert_trees(got[key], want[key], **STATE_TOL)
        for key in ("u_hist", "g_u_hist"):
            np.testing.assert_allclose(got[key], want[key], **STATE_TOL)
        assert int(got["round"]) == int(want["round"]) == r + 1
        rmet = jax.device_get(rmet)
        assert set(tmet) == set(rmet) == set(DIAGS)
        for key in DIAGS:
            np.testing.assert_allclose(tmet[key].numpy(), rmet[key],
                                       **DIAG_TOL, err_msg=f"{r} {key}")
        sync = (r + 1) % 2 == 0
        assert bool(tmet["g_h2"].any()) == sync, r
        if r == 1:  # the dark rack is refused at the sync
            assert tmet["g_h1"][0] == tmet["g_h2"][0] == 0
        if actives[r] is not None:  # the vacant rack reports zero
            assert not tmet["g_u"][-1] and not tmet["u"][last].any()
    if clip:
        assert np.isfinite(_leaves(got["workers"])[0]).all()


# ---------------------------------------------------------------------------
# (d) the degenerate topology inside the port
# ---------------------------------------------------------------------------

def test_forced_degenerate_hierarchy_is_flat_fused_bit_for_bit():
    """One rack and a global period of 1 forced through the hierarchical
    state: three full rounds (sgd local steps, failures) give the flat
    fused trainer's state bit for bit, the lone sub-master equals the
    master, and the rack diagnostics are (1,) zeros."""
    ekw = dict(num_workers=4, tau=2, alpha=0.1, dynamic=True,
               comm_mode="fused")
    _, flat = _trainers(ekw)
    _, hier = _trainers(ekw, hierarchical=True)
    assert hier._hier and hier._n_groups == 1 and not flat._hier
    rng = np.random.default_rng(5)
    states = [t.init_state(_params()) for t in (flat, hier)]
    for state in states:
        torch.manual_seed(1)
        state["workers"].add_(0.1 * torch.randn_like(state["workers"]))
    for r in range(3):
        batches = {"images": torch.from_numpy(rng.standard_normal(
            (2, 4, 2, 28, 28, 1)).astype(np.float32)),
            "labels": torch.from_numpy(rng.integers(0, 10, (2, 4, 2)))}
        fail = rng.random(4) < 0.3
        inputs = TInputs(batches=batches, round=r, fail=fail,
                         failed_recent=fail)
        (_, mf), (_, mh) = (t.round_step(s, inputs)
                            for t, s in zip((flat, hier), states))
        for key in ("u", "score", "h1", "h2", "loss"):
            assert torch.equal(mf[key], mh[key]), key
        for key in ("g_u", "g_score", "g_h1", "g_h2"):
            assert torch.equal(mh[key], torch.zeros(1))
    sf, sh = states
    for key in ("workers", "master", "master_prev", "u_hist"):
        assert torch.equal(sf[key], sh[key]), key
    assert torch.equal(sh["submasters"][0], sh["master"])


def test_hierarchy_needs_fused_comm_and_no_staleness():
    with pytest.raises(ValueError, match="fused"):
        _trainers(dict(num_workers=4), hierarchical=True)
    with pytest.raises(ValueError, match="staleness"):
        _trainers(dict(num_workers=4, comm_mode="fused", staleness=1),
                  hierarchical=True)
