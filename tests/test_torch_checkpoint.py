"""Checkpoints across the two packages: the port's
``repro_torch.checkpoint`` against the reference's ``repro.checkpoint`` —
the same on-disk format, read and written in both directions bit for bit
(float32, bfloat16 stored widened with its dtype in the manifest, int32,
a leaf split across shards), the same manifest and metadata, the same
u-history re-seating — and the port's ``ElasticSession.save`` /
``restore`` / ``RunSpec.save_path`` against the reference's sessions."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import ElasticSession as RSession
from repro.api.session import RunSpec as RSpec
from repro.checkpoint import checkpoint as rck
from repro.configs.base import ElasticConfig as RElastic
from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.nn.param import params_from_numpy, tree_leaves
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer": {"w": rng.standard_normal((33, 17)).astype(np.float32),
                  "b": np.asarray(rng.standard_normal(40), jnp.bfloat16)},
        "stack": [rng.standard_normal(5).astype(np.float32),
                  rng.integers(-9, 9, 3).astype(np.int32)],
        "scale": np.float32(rng.standard_normal()),
    }


def _bits(x):
    """Raw bits of a leaf (torch tensor or numpy array) for exact
    comparison; bfloat16 as int16."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _dtype(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _assert_trees_bitwise(got, want):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys()
    for path in want:
        assert _dtype(got[path]) == _dtype(want[path]), path
        np.testing.assert_array_equal(_bits(got[path]), _bits(want[path]),
                                      err_msg=str(path))


def _as_dicts(tree):
    """The list node of :func:`_numpy_tree` as a dict, so ``tree_leaves``
    walks it."""
    return {**tree, "stack": dict(enumerate(tree["stack"]))}


def _torch_tree(tree):
    return {"layer": params_from_numpy(tree["layer"]),
            "stack": [torch.from_numpy(x) for x in tree["stack"]],
            "scale": torch.tensor(tree["scale"])}


@pytest.mark.parametrize("shard_bytes", [None, 256])
def test_reference_checkpoint_restores_bitwise_in_the_port(
        tmp_path, monkeypatch, shard_bytes):
    """A reference ``save`` (bfloat16 widened, a 2244-byte leaf split into
    parts when shards hold 256 bytes) read by the port's ``restore``: the
    same leaves, dtypes and bits, with and without ``like``."""
    if shard_bytes:
        monkeypatch.setattr(rck, "MAX_SHARD_BYTES", shard_bytes)
    tree = _numpy_tree()
    meta = {"rounds": 3, "arch": "paper-cnn", "nested": {"k": [1, 2]}}
    rck.save(str(tmp_path), tree, metadata=meta)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert ("parts" in manifest["keys"]["layer/w"]) == bool(shard_bytes)
    assert manifest["keys"]["layer/b"]["dtype"] == "bfloat16"
    got, got_meta = tck.restore(str(tmp_path))
    assert got_meta == meta == tck.read_metadata(str(tmp_path))
    assert isinstance(got["stack"], list)
    _assert_trees_bitwise(_as_dicts(got), _as_dicts(tree))
    like = _torch_tree(tree)
    got, _ = tck.restore(str(tmp_path), like=like)
    _assert_trees_bitwise(_as_dicts(got), _as_dicts(tree))


@pytest.mark.parametrize("shard_bytes", [None, 256])
def test_port_checkpoint_restores_bitwise_in_the_reference(
        tmp_path, monkeypatch, shard_bytes):
    """A port ``save`` of torch tensors read by the reference's
    ``restore``; both packages write the same manifest and the same npz
    entries for the same tree."""
    for mod in (rck, tck):
        if shard_bytes:
            monkeypatch.setattr(mod, "MAX_SHARD_BYTES", shard_bytes)
    tree = _numpy_tree(1)
    meta = {"rounds": 7, "scenario": "iid"}
    tck.save(str(tmp_path / "port"), _torch_tree(tree), metadata=meta)
    rck.save(str(tmp_path / "ref"), tree, metadata=meta)
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    for i in range(manifests[0]["num_shards"]):
        name = f"shard_{i:05d}.npz"
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "ref" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
    got, got_meta = rck.restore(str(tmp_path / "port"))
    assert got_meta == meta
    _assert_trees_bitwise(_as_dicts(got), _as_dicts(tree))
    got, _ = rck.restore(str(tmp_path / "port"), like=tree)
    _assert_trees_bitwise(_as_dicts(jax.device_get(got)), _as_dicts(tree))


def test_fingerprint_and_manifest_helpers_match(tmp_path):
    assert tck.read_fingerprint(str(tmp_path)) is None
    tck.save(str(tmp_path), {"w": torch.zeros(3)})
    fp = tck.read_fingerprint(str(tmp_path))
    assert fp is not None and fp == rck.read_fingerprint(str(tmp_path))
    rng = np.random.default_rng(2)
    active = rng.random(6) < 0.6
    u_hist = rng.standard_normal((6, 5)).astype(np.float32)
    assert (tck.elastic_manifest(active, u_hist)
            == rck.elastic_manifest(active, u_hist))
    assert (tck.elastic_manifest(active, u_hist, groups=2, global_period=3,
                                 g_u_hist=u_hist[:2])
            == rck.elastic_manifest(active, u_hist, groups=2,
                                    global_period=3, g_u_hist=u_hist[:2]))
    # the hierarchy's re-seats: a flat checkpoint (None) seats every rack
    # blank / from the master, as in the reference
    np.testing.assert_array_equal(tck.reseat_group_hist(None, 2, 5),
                                  rck.reseat_group_hist(None, 2, 5))
    master = {"w": u_hist[0]}
    for name in ("reseat_group_hist", "reseat_submasters"):
        args = ((u_hist[:3], 2, 5) if name == "reseat_group_hist"
                else ({"w": u_hist[:3]}, master, 2))
        got, want = getattr(tck, name)(*args), getattr(rck, name)(*args)
        got = got["w"].numpy() if isinstance(got, dict) else got
        want = np.asarray(want["w"] if isinstance(want, dict) else want)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("saved_cap,saved_window,cap,window,live", [
    (4, 5, 4, 5, None), (4, 5, 6, 5, [1, 1, 0, 1, 1, 0]),
    (6, 5, 3, 5, None), (4, 3, 4, 5, [0, 1, 1, 1]), (4, 6, 5, 4, None)])
def test_reseat_u_hist_matches_reference(saved_cap, saved_window, cap, window,
                                         live):
    rng = np.random.default_rng(saved_cap * 10 + cap)
    saved_active = np.arange(saved_cap) != 1
    meta = rck.elastic_manifest(saved_active, rng.standard_normal(
        (saved_cap, saved_window)).astype(np.float32))
    live = np.ones(cap, bool) if live is None else np.asarray(live, bool)
    for m in (meta, None, {"active": [1], "u_hist": [1.0]}):
        np.testing.assert_array_equal(
            tck.reseat_u_hist(m, cap, live, window),
            rck.reseat_u_hist(m, cap, live, window))


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def _elastic(k=3):
    return dict(num_workers=k, tau=1, comm_mode="fused")


def _port_spec(**kw):
    base = dict(elastic=TElastic(**_elastic()), rounds=2, batch_size=4,
                n_data=200, n_test=16, device="cpu")
    base.update(kw)
    return RunSpec(**base)


def test_save_path_checkpoint_restores_in_both_sessions(tmp_path):
    """``RunSpec.save_path`` saves at the end of the run with the
    reference's metadata. The port's ``restore`` re-seats it (master bit
    for bit, workers from the master with fresh optimizer state, saved
    u-histories), and the reference session's ``restore`` reads the same
    master and u-histories from the port's checkpoint."""
    path = str(tmp_path / "ck")
    sess = ElasticSession(_port_spec(save_path=path))
    sess.run()
    meta = tck.read_metadata(path)
    assert {k: meta[k] for k in ("rounds", "arch", "scenario")} == {
        "rounds": 2, "arch": "paper-cnn", "scenario": "iid"}
    assert meta["elastic"]["capacity"] == 3
    np.testing.assert_array_equal(meta["elastic"]["u_hist"],
                                  sess.state["u_hist"].numpy())

    warm = ElasticSession(_port_spec(rounds=3))
    assert warm.restore(path) == meta
    assert torch.equal(warm.state["master"], sess.state["master"])
    assert torch.equal(warm.state["master_prev"], sess.state["master"])
    assert torch.equal(warm.state["workers"],
                       sess.state["master"].expand(3, -1))
    assert torch.equal(warm.state["u_hist"], sess.state["u_hist"])
    assert not warm.state["opt"]["count"].any()
    assert all(np.isfinite(r.loss) for r in warm.run())

    ref = RSession(RSpec(elastic=RElastic(**_elastic()), rounds=2,
                         batch_size=4, n_data=200, n_test=16))
    ref.restore(path)
    want = warm.layout.to_numpy(sess.state["master"])
    _assert_trees_bitwise(jax.device_get(ref.state["master"]), want)
    np.testing.assert_array_equal(np.asarray(ref.state["u_hist"]),
                                  sess.state["u_hist"].numpy())


def test_reference_session_checkpoint_warm_starts_the_port(tmp_path):
    """A reference session's ``save`` (elastic manifest of 4 slots) warm
    starts a port session of 3 workers: the master bit for bit, the first
    three saved u-histories re-seated in order."""
    ref = RSession(RSpec(elastic=RElastic(**_elastic(4)), rounds=1,
                         batch_size=4, n_data=200, n_test=16))
    ref.state = dict(ref.state, u_hist=jnp.asarray(
        np.random.default_rng(3).standard_normal((4, 5)), jnp.float32))
    path = ref.save(str(tmp_path / "ref"))
    sess = ElasticSession(_port_spec())
    meta = sess.restore(path)
    assert meta["elastic"]["capacity"] == 4
    _assert_trees_bitwise(sess.layout.to_numpy(sess.state["master"]),
                          jax.device_get(ref.state["master"]))
    np.testing.assert_array_equal(sess.state["u_hist"].numpy(),
                                  np.asarray(ref.state["u_hist"])[:3])
    with pytest.raises(ValueError, match="arch"):
        bad = str(tmp_path / "bad")
        tck.save(bad, {"w": torch.zeros(1)}, metadata={"arch": "qwen3-4b"})
        sess.restore(bad)


def test_plain_session_save_restore(tmp_path):
    """Plain mode saves its single worker's params (scenario "none", no
    elastic manifest); a restore replaces the params and keeps the
    optimizer state, as the reference's does."""
    sess = ElasticSession(_port_spec(plain=True, rounds=2))
    sess.run()
    path = sess.save(str(tmp_path / "plain"))
    meta = tck.read_metadata(path)
    assert meta == {"rounds": 2, "arch": "paper-cnn", "scenario": "none"}
    other = ElasticSession(_port_spec(plain=True, rounds=1, seed=5))
    other.run()
    m_before = other.state["opt"]["m"].clone()
    other.restore(path)
    assert torch.equal(other.state["params"], sess.state["params"])
    assert torch.equal(other.state["opt"]["m"], m_before)
    got, _ = rck.restore(path)
    _assert_trees_bitwise(got, sess.layout.to_numpy(sess.state["params"]))
    assert os.path.exists(os.path.join(path, "shard_00000.npz"))
