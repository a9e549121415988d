"""Checkpoint hot-swap in the port (``repro_torch.serving.hotswap``), held
to the reference's three hot-swap tests (``tests/test_serving_continuous.py``)
across packages, on the CPU.

A reference ``ElasticSession`` on stablelm-smoke (module-scoped: one
compiled session) saves two masters, after rounds 2 and 4; the second
save is forced multi-shard. A test "lands" a save in the watched
directory by copying its shards and then its manifest (the order
``checkpoint.save`` writes them in), so the port's ``CheckpointWatcher``
on a port ``ContinuousEngine`` sees what a live session's save would
give it:

- the swap leaves the in-flight request's tokens untouched and drains it
  to its budget; post-swap tokens equal those of a fresh port engine
  restored from that checkpoint, bit for bit;
- the post-swap prefill logits match the reference model restored from
  the same checkpoint (float32: rtol 1e-4 / atol 1e-5; bfloat16: 0.08);
- an arch mismatch is journalled once and skipped;
- the scheduler's ``poll_every`` drives one swap;
- the serve CLI's ``--restore`` and ``--watch`` run on the CPU, a save
  landing mid-run swapped in.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rck
from repro.configs.base import get_config as rget
from repro.models.registry import build_model as rbuild
from repro.nn.param import init_tree as rinit
from repro_torch.checkpoint import checkpoint
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import build_model as tbuild
from repro_torch.nn.param import init_tree, tree_leaves
from repro_torch.serving import (CheckpointWatcher, ContinuousEngine,
                                 Scheduler)
from repro_torch.serving.traffic import TrafficConfig, synthetic_traffic
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "stablelm_3b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=0.08, atol=0.08)}


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """(after 2 rounds, after 4 rounds forced multi-shard) of one
    reference session, as in the reference's ``_lm_session``."""
    from repro.api import ElasticSession, RunSpec
    from repro.configs.base import ElasticConfig, OptimizerConfig

    root = tmp_path_factory.mktemp("session")
    sess = ElasticSession(RunSpec(
        arch="stablelm-3b", smoke=True,
        optimizer=OptimizerConfig(name="sgd", lr=0.01),
        elastic=ElasticConfig(num_workers=2, tau=1, dynamic=True),
        rounds=4, seed=1, n_tokens=4000, seq_len=16, batch_size=2))
    sess.run(2)
    first = sess.save(str(root / "rounds2"))
    sess.run(2)
    old = rck.MAX_SHARD_BYTES
    rck.MAX_SHARD_BYTES = 4096
    try:
        second = sess.save(str(root / "rounds4"))
    finally:
        rck.MAX_SHARD_BYTES = old
    assert sum(f.endswith(".npz") for f in os.listdir(second)) > 1
    return first, second


def _land(src, dst):
    """Copy a checkpoint's shards, then its manifest, into ``dst``."""
    os.makedirs(dst, exist_ok=True)
    names = sorted(os.listdir(src))
    for name in [n for n in names if n != "manifest.json"] + [
            "manifest.json"]:
        shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))


def _engine(dtype=None, seed=0, **kw):
    cfg = tget(ARCH, smoke=True)
    if dtype:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    model = tbuild(cfg)
    params = init_tree(torch.Generator().manual_seed(seed), model.spec)
    return ContinuousEngine(model, params, **kw)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def test_hotswap_tracks_reference_session(saves, tmp_path):
    ck = str(tmp_path / "ck")
    _land(saves[0], ck)
    eng = _engine(capacity=2, max_len=32, prefill_len=8)
    watcher = CheckpointWatcher(eng, ck)
    assert watcher.expect_arch == "stablelm-smoke"
    assert watcher.poll() is False  # the baseline: nothing new

    eng.admit(_prompt(8, 0), max_new=12, rid=0)
    eng.step()
    eng.step()
    pre_swap = list(eng._slots[eng.active_slots()[0]].tokens)

    _land(saves[1], ck)  # the session's next save, multi-shard
    assert watcher.poll() is True
    assert eng.swaps == 1 and watcher.swaps_applied == 1
    ev = watcher.log[-1]
    assert ev.applied and ev.rounds == 4 and ev.arch == "stablelm-smoke"
    assert ev.tick == 2
    assert watcher.poll() is False  # the same save is not swapped twice

    done = []
    while eng.num_active:
        done += eng.step()
    (f,) = done
    assert f.rid == 0 and f.tokens.size == 12 and f.reason == "length"
    assert f.tokens[:len(pre_swap)].tolist() == pre_swap

    fresh_params, _ = checkpoint.restore(ck, like=eng.params)
    for (path, a), (_, b) in zip(tree_leaves(eng.params),
                                 tree_leaves(fresh_params)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    fresh = ContinuousEngine(eng.model, fresh_params, capacity=2,
                             max_len=32, prefill_len=8)
    p2 = _prompt(6, 8)
    for e in (eng, fresh):
        e.admit(p2, max_new=5, rid=1)
    got = want = []
    while eng.num_active:
        got = eng.step()
    while fresh.num_active:
        want = fresh.step()
    assert got[0].tokens.tolist() == want[0].tokens.tolist()
    assert got[0].tokens.size == 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_post_swap_prefill_matches_reference(saves, tmp_path, dtype):
    """After the swap the engine's params give the reference model's
    prefill logits when it is restored from the same checkpoint."""
    ck = str(tmp_path / "ck")
    _land(saves[0], ck)
    eng = _engine(dtype, capacity=1, max_len=24, prefill_len=16)
    watcher = CheckpointWatcher(eng, ck)
    _land(saves[1], ck)
    assert watcher.poll() is True

    rmodel = rbuild(rget(ARCH, smoke=True).replace(dtype=dtype,
                                                   param_dtype=dtype))
    rparams, meta = rck.restore(ck, like=rinit(jax.random.key(0),
                                               rmodel.spec))
    assert meta["rounds"] == 4
    toks = _prompt(16, 3)[None]
    want, _ = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)},
                             rmodel.init_cache(1, 16))
    got, _ = eng.model.prefill(eng.params, {"tokens": torch.from_numpy(toks)},
                               eng.model.init_cache(1, 16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_hotswap_rejects_arch_mismatch(saves, tmp_path):
    """A checkpoint of another arch is journalled once and skipped; the
    served params keep working, and a later matching save swaps in."""
    ck = str(tmp_path / "ck")
    eng = _engine(capacity=1, max_len=16, prefill_len=8)
    watcher = CheckpointWatcher(eng, ck)  # no checkpoint yet
    assert watcher.poll() is False and watcher.log == []
    rck.save(ck, {"w": np.zeros(3, np.float32)},
             metadata={"arch": "paper-cnn", "rounds": 1})
    assert watcher.poll() is False
    assert eng.swaps == 0
    (ev,) = watcher.log
    assert not ev.applied and "arch mismatch" in ev.note
    assert ev.arch == "paper-cnn" and ev.rounds == 1
    assert watcher.poll() is False  # the same bad checkpoint: not re-read
    assert len(watcher.log) == 1
    eng.admit(_prompt(8, 1), max_new=3)
    while eng.num_active:
        eng.step()
    _land(saves[1], ck)
    assert watcher.poll() is True and len(watcher.log) == 2


def test_scheduler_polls_watcher(saves, tmp_path):
    """The scheduler's ``poll_every`` cadence drives the watcher: a save
    landing after the baseline is swapped in at the first poll, tick 2,
    and polls run on even ticks only."""
    ck = str(tmp_path / "ck")
    _land(saves[0], ck)
    eng = _engine(capacity=2, max_len=48, prefill_len=8)
    watcher = CheckpointWatcher(eng, ck)
    _land(saves[1], ck)
    polled = []
    poll = watcher.poll
    watcher.poll = lambda: polled.append(eng.ticks) or poll()
    sched = Scheduler(eng, watcher=watcher, poll_every=2)
    trace = synthetic_traffic(TrafficConfig(
        num_requests=6, prompt_lens=(4, 8), max_new=16, vocab_size=256,
        seed=5))
    results = sched.run(trace)
    assert len(results) == 6 and all(r.num_tokens == 16 for r in results)
    assert watcher.swaps_applied == 1 and eng.swaps == 1
    assert [e.tick for e in watcher.log] == [2]
    assert polled[0] == 2 and all(t % 2 == 0 for t in polled)
    assert len(polled) == eng.ticks // 2


def test_serve_cli_restore_and_watch(saves, tmp_path, monkeypatch, capsys):
    """``--restore`` reads a master saved by the reference session;
    ``--watch`` swaps in a save that lands during the run (here: just
    before the first poll)."""
    ck = str(tmp_path / "ck")
    _land(saves[0], ck)

    class Landing(CheckpointWatcher):
        def poll(self):
            if not self.log:
                _land(saves[1], ck)
            return super().poll()

    monkeypatch.setattr(tserve, "CheckpointWatcher", Landing)
    tserve.main(["--arch", "stablelm-3b", "--device", "cpu", "--traffic",
                 "3", "--steps", "6", "--prompt-len", "8", "--restore", ck,
                 "--watch", ck, "--poll-every", "2"])
    out = capsys.readouterr().out
    assert f"restored {ck} (arch=stablelm-smoke, rounds=2)" in out
    assert "served 3/3 requests, 18 tokens" in out
    assert "(arch guard: stablelm-smoke)" in out
    assert "hot-swaps applied: 1" in out
    tserve.main(["--arch", "h2o-danube-1.8b", "--device", "cpu", "--batch",
                 "2", "--steps", "3", "--prompt-len", "8"])
    assert "serving danube-smoke" in capsys.readouterr().out
