"""Hierarchical averaging in the port's session and checkpoints, against
the JAX reference (the trainer-level checks are in
tests/test_torch_hierarchy.py).

- One ``ElasticSession`` run at the ROADMAP's end-to-end tolerances
  (``_assert_state_close`` / ``_close`` of tests/test_torch_session.py,
  whose docstring gives the reasons), with the sub-masters held norm-wise
  per leaf within 1e-3, the rack u-histories and rack records at the
  diagnostics bar.
- The rack re-seats of ``checkpoint`` equal the reference's; hierarchical
  checkpoints cross the two packages bit for bit, sub-masters included;
  a restore at another rack count seats what the reference seats.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import ElasticSession as RSession
from repro.api.session import RunSpec as RSpec
from repro.checkpoint import checkpoint as rck
from repro.configs.base import ElasticConfig as RElastic
from repro.configs.base import OptimizerConfig as ROpt
from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.nn.param import tree_leaves
from test_torch_hierarchy import _assert_trees, _leaves
from test_torch_session import (SEED, _assert_state_close, _close, _configs,
                                _round_probes,
                                one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# (e) one session, end to end
# ---------------------------------------------------------------------------

CAP, GROUPS, PERIOD, ROUNDS = 6, 2, 2, 3


def _session_kw(**kw):
    base = dict(rounds=ROUNDS, batch_size=4, n_data=200, n_test=16,
                seed=SEED, eval_every=1)
    base.update(kw)
    return base


def test_session_matches_reference():
    """DEAHES-O, fused, capacity 6 in racks of 3, a global sync every 2
    rounds, 3 rounds under the iid schedule; the reference's probes are
    injected and its initial params carried across. Every round's state
    (sub-masters and rack u-histories too) and record (rack fields too)
    agree at the end-to-end tolerances."""
    ekw, okw = _configs("DEAHES-O", CAP, "fused")
    ekw.update(groups=GROUPS, global_period=PERIOD)
    ref = RSession(RSpec(elastic=RElastic(**ekw), optimizer=ROpt(**okw),
                         **_session_kw()))
    probes = {r: torch.from_numpy(_round_probes(
        jax.random.fold_in(jax.random.key(SEED), r), CAP))
        for r in range(ROUNDS)}
    sess = ElasticSession(
        RunSpec(elastic=TElastic(**ekw), optimizer=TOpt(**okw),
                device="cpu", **_session_kw()),
        params=jax.device_get(ref.state["master"]),
        probe_fn=lambda r, t, i: probes[r][t, i][None])
    for r in range(ROUNDS):
        (want,), (got,) = ref.run(1), sess.run(1)
        tstate = sess.trainer.state_to_numpy(sess.state)
        rstate = jax.device_get(ref.state)
        _assert_state_close(tstate, rstate, f"round {r}")
        for e, (sg, sw) in enumerate(zip(_leaves(tstate["submasters"]),
                                         _leaves(rstate["submasters"]))):
            d = np.linalg.norm(sg - sw)
            assert d <= 1e-3 * np.linalg.norm(sw), f"round {r} sub leaf {e}"
        _close(tstate["g_u_hist"], rstate["g_u_hist"], f"round {r} g_u_hist")
        for key in ("loss", "u", "score", "h1", "h2", "loss_w",
                    "g_u", "g_score", "g_h1", "g_h2"):
            _close(getattr(got, key), getattr(want, key), f"round {r} {key}")
        assert bool(np.any(got.g_h2)) == ((r + 1) % PERIOD == 0)


# ---------------------------------------------------------------------------
# (f) checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("saved,target,window", [
    (2, 2, 5), (2, 3, 5), (3, 2, 5), (None, 2, 5), (3, 3, 4), (2, 4, 6)])
def test_reseat_racks_match_reference(saved, target, window):
    rng = np.random.default_rng(17)
    master = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal(5).astype(np.float32)}
    hist = subs = None
    if saved is not None:
        hist = rng.standard_normal((saved, 5)).astype(np.float32)
        subs = jax.tree.map(lambda m: rng.standard_normal(
            (saved,) + m.shape).astype(np.float32), master)
    np.testing.assert_array_equal(
        tck.reseat_group_hist(hist, target, window),
        rck.reseat_group_hist(hist, target, window))
    got = tck.reseat_submasters(subs, master, target)
    want = rck.reseat_submasters(subs, master, target)
    assert all(isinstance(x, torch.Tensor) for _, x in tree_leaves(got))
    _assert_trees(got, jax.device_get(want), exact=True)


def _sgd_spec(groups, k=5, rounds=2):
    return dict(elastic=dict(num_workers=k, tau=1, comm_mode="fused",
                             groups=groups, global_period=2),
                optimizer=dict(name="sgd", lr=0.01),
                kw=dict(rounds=rounds, batch_size=4, n_data=64, n_test=16,
                        seed=1))


def _port_session(groups, **kw):
    s = _sgd_spec(groups, **kw)
    return ElasticSession(RunSpec(elastic=TElastic(**s["elastic"]),
                                  optimizer=TOpt(**s["optimizer"]),
                                  device="cpu", **s["kw"]))


def _ref_session(groups, **kw):
    s = _sgd_spec(groups, **kw)
    return RSession(RSpec(elastic=RElastic(**s["elastic"]),
                          optimizer=ROpt(**s["optimizer"]), **s["kw"]))


def _hier_state(sess):
    """(master, sub-masters, g_u_hist) of either package's session as
    numpy trees."""
    if isinstance(sess, ElasticSession):
        st = sess.trainer.state_to_numpy(sess.state)
    else:
        st = jax.device_get(sess.state)
    return st["master"], st["submasters"], np.asarray(st["g_u_hist"])


def _assert_hier_equal(got, want):
    for g, w in zip(got[:2], want[:2]):
        _assert_trees(g, w, exact=True)
    np.testing.assert_array_equal(got[2], want[2])


def test_hierarchical_checkpoints_cross_packages_bit_for_bit(tmp_path):
    """A port session's hierarchical checkpoint restores in a reference
    session, and the reference's in the port's: master, sub-masters and
    rack u-histories bit for bit, the manifests' metadata equal."""
    port = _port_session(2)
    port.run()
    port.save(str(tmp_path / "port"))
    ref = _ref_session(2)
    meta = ref.restore(str(tmp_path / "port"))
    assert meta["elastic"]["groups"] == 2
    assert meta["elastic"]["global_period"] == 2
    _assert_hier_equal(_hier_state(ref), _hier_state(port))

    # the reference's own checkpoint, its racks moved off the master
    rng = np.random.default_rng(3)
    ref.state["submasters"] = jax.tree.map(
        lambda x: x + jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        ref.state["submasters"])
    ref.state["g_u_hist"] = jnp.asarray(rng.standard_normal(
        ref.state["g_u_hist"].shape), jnp.float32)
    ref.save(str(tmp_path / "ref"))
    back = _port_session(2)
    assert back.restore(str(tmp_path / "ref")) == rck.read_metadata(
        str(tmp_path / "ref"))
    _assert_hier_equal(_hier_state(back), _hier_state(ref))
    # the sub-checkpoints hold the same keys, shapes and bits
    sub_t, _ = rck.restore(str(tmp_path / "port" / "submasters"))
    sub_r, _ = tck.restore(str(tmp_path / "ref" / "submasters"))
    _assert_trees(sub_t, _hier_state(port)[1], exact=True)
    _assert_trees(sub_r, _hier_state(ref)[1], exact=True)


def test_restore_at_another_rack_count_matches_reference(tmp_path):
    """A 2-rack checkpoint restored at 3 racks, and a flat one at 2: both
    packages seat the same sub-masters (saved racks first, the rest from
    the master) and rack u-histories."""
    src = _port_session(2)
    src.run()
    path = str(tmp_path / "ck")
    src.save(path)
    got, want = _port_session(3, k=6), _ref_session(3, k=6)
    got.restore(path)
    want.restore(path)
    _assert_hier_equal(_hier_state(got), _hier_state(want))
    subs = _leaves(_hier_state(got)[1])
    saved = _leaves(_hier_state(src)[1])
    master = _leaves(_hier_state(got)[0])
    np.testing.assert_array_equal(subs[0][:2], saved[0])
    np.testing.assert_array_equal(subs[0][2], master[0])

    flat = ElasticSession(dataclasses.replace(
        src.spec, elastic=TElastic(num_workers=5, tau=1, comm_mode="fused")))
    flat.restore(path)
    assert "submasters" not in flat.state
    flat.save(str(tmp_path / "flat"))
    got, want = _port_session(2), _ref_session(2)
    got.restore(str(tmp_path / "flat"))
    want.restore(str(tmp_path / "flat"))
    _assert_hier_equal(_hier_state(got), _hier_state(want))
    assert (got.state["submasters"] == got.state["master"]).all()
