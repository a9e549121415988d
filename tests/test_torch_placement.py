"""Sharded placement in one process: the configuration rules (the
counterparts of tests/test_placement.py's validation tests), the capacity
padding and slot split, the sharded code at world size 1 (no process
group: the gather is the identity) bit for bit against single placement
and within ROADMAP's tolerances against the reference's single placement,
and the comm phase's gather-then-exchange at world size 2, each rank's
trainer run here with the gather handed the other rank's rows. The
two-rank runs on a real process group are in
tests/test_torch_distributed.py."""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro.configs.base import ElasticConfig as RElastic
import repro_torch.api.session as tsession
from repro_torch.api.session import ElasticSession
from repro_torch.configs.base import ElasticConfig, OptimizerConfig
from repro_torch.core import coordinator
from repro_torch.launch import mesh
from repro_torch.launch import train as ttrain
from test_torch_session import one_torch_thread  # noqa: F401
from test_torch_session import run_parity

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_placement_validated():
    for cfg in (ElasticConfig, RElastic):
        with pytest.raises(ValueError):
            cfg(placement="nope")


def test_sharded_requires_fused_comm():
    """The reference's own ``ValueError``, from the config and from the
    CLI (whose comm mode defaults to sequential)."""
    for cfg in (ElasticConfig, RElastic):
        with pytest.raises(ValueError, match="fused"):
            cfg(placement="sharded", comm_mode="sequential")
        cfg(placement="sharded", comm_mode="fused")  # ok
    with pytest.raises(ValueError, match="requires comm_mode='fused'"):
        ttrain.main(["--device", "cpu", "--placement", "sharded"])


def test_capacity_padded_and_split(monkeypatch):
    """Capacity pads up to a multiple of the world size and splits into
    contiguous blocks; a session at world size 2 (the group faked) pads 3
    workers to 4 slots, the padded slot vacant, and holds its rank's
    rows."""
    assert [mesh.padded_capacity(c, 2) for c in (1, 2, 3, 4, 7)] == [
        2, 2, 4, 4, 8]
    assert mesh.padded_capacity(7, 1) == 7
    assert [mesh.shard_slots(8, 2, r) for r in (0, 1)] == [(0, 4), (4, 8)]
    assert mesh.shard_slots(6, 3, 2) == (4, 6)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        mesh.shard_slots(5, 2, 0)
    with pytest.raises(ValueError, match="rank 2 outside"):
        mesh.shard_slots(4, 2, 2)
    assert mesh.world_and_rank() == (1, 0)
    for rank in (0, 1):
        for mod in (coordinator, tsession):
            monkeypatch.setattr(mod, "world_and_rank",
                                lambda group=None: (2, rank))
        ecfg = ElasticConfig(num_workers=3, comm_mode="fused",
                             placement="sharded")
        with pytest.raises(ValueError, match="does not split"):
            coordinator.ElasticTrainer(None, OptimizerConfig(), ecfg,
                                       device="cpu")
        sess = ElasticSession(dataclasses.replace(
            ranks.spec("flat", "sharded"),
            elastic=dataclasses.replace(ecfg, tau=1)))
        assert sess.capacity == 4 and sess.ecfg.num_workers == 3
        assert sess.active_mask.tolist() == [True, True, True, False]
        assert (sess.trainer._lo, sess.trainer._hi) == (2 * rank,
                                                         2 * rank + 2)
        assert sess.state["workers"].shape == (2, sess.layout.n)
        assert sess.state["u_hist"].shape[0] == 4


def test_init_distributed_validates_before_joining():
    """A rank outside the world, or a group with no address, raises before
    any rendezvous; the CPU's backend is gloo."""
    with pytest.raises(ValueError, match="process id 2 outside 0..1"):
        mesh.init_distributed("127.0.0.1:1", 2, 2, "cpu")
    with pytest.raises(ValueError, match="needs a coordinator address"):
        mesh.init_distributed(None, 2, 0, "cpu")
    assert not torch.distributed.is_initialized()


def _sharded(spec):
    return dataclasses.replace(spec, elastic=dataclasses.replace(
        spec.elastic, placement="sharded"))


@pytest.mark.parametrize("name", ranks.SCENARIOS)
def test_world_size_1_runs_like_single_bit_for_bit(name):
    """With no process group the sharded session is single placement, bit
    for bit: state, records and the mean loss."""
    spec = ranks.spec(name, "single")
    got, want = (ElasticSession(s) for s in (_sharded(spec), spec))
    assert got.trainer._sharded and got.trainer._world == 1
    recs = [ranks.run(s) for s in (got, want)]
    a, b = (ranks.summary(s, r) for s, r in zip((got, want), recs))
    assert a.keys() == b.keys()
    for key in a:
        if key.startswith("rec/"):
            assert all(np.array_equal(x, y) for x, y in zip(a[key], b[key]))
        else:
            assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("name", ["flat", "hier"])
def test_comm_phase_gather_then_exchange_matches_single(name, monkeypatch):
    """The comm phase of each of two ranks, run here, on the same spread
    state: the gather hands back both ranks' pre-exchange rows, and each
    rank's master, sub-masters, u-histories and metrics equal single
    placement's bit for bit, and so do its own worker rows after the
    exchange (fail mask with a dead slot on each rank; under hierarchy the
    padded slot vacant and rack 1 on both ranks)."""
    spec = ranks.spec(name, "single")
    single = ElasticSession(spec)
    st = single.state
    gen = torch.Generator().manual_seed(19)
    st["workers"] += 0.01 * torch.randn(st["workers"].shape, generator=gen)
    if "submasters" in st:
        st["submasters"] += 0.01 * torch.randn(st["submasters"].shape,
                                               generator=gen)
    st["u_hist"].uniform_(-6.0, -2.0, generator=gen)
    cap = single.capacity
    fail = np.zeros(cap, bool)
    fail[[0, cap - 2]] = True
    active = single.active_mask if single.schedule.has_membership else None
    pre = {key: (val.clone() if torch.is_tensor(val) else val)
           for key, val in st.items() if key != "opt"}
    want = single.trainer.comm_phase(st, fail, active=active)

    def fake_gather(local, group=None):
        assert local.shape[0] == cap // 2
        return pre["workers"].clone()

    monkeypatch.setattr(coordinator, "gather_rows", fake_gather)
    for rank in (0, 1):
        monkeypatch.setattr(coordinator, "world_and_rank",
                            lambda group=None: (2, rank))
        trainer = coordinator.ElasticTrainer(
            single.model, spec.optimizer,
            dataclasses.replace(single.ecfg, placement="sharded"),
            device="cpu")
        lo, hi = trainer._lo, trainer._hi
        assert (lo, hi) == (rank * cap // 2, (rank + 1) * cap // 2)
        state = {key: (val.clone() if torch.is_tensor(val) else val)
                 for key, val in pre.items()}
        state["workers"] = pre["workers"][lo:hi].clone()
        got = trainer.comm_phase(state, fail, active=active)
        for key in want:
            assert torch.equal(got[key], want[key]), (rank, key)
        for key in ("master", "master_prev", "u_hist", "submasters",
                    "g_u_hist"):
            if key in st:
                assert torch.equal(state[key], st[key]), (rank, key)
        assert torch.equal(state["workers"], st["workers"][lo:hi])
        assert state["round"] == st["round"] == 1


def test_world_size_1_matches_reference_round_step():
    """The sharded code at world size 1 against the reference's single
    placement ``round_step``: DEAHES-O, k=2, fused, 3 rounds, the
    reference's probes injected, at ROADMAP's tolerances (``run_parity``)."""
    run_parity("DEAHES-O", 2, "fused", "iid", placement="sharded")
