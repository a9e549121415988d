"""Hot-swap from a live training session, all in the port: the reference's
acceptance scenario (``tests/test_serving_continuous.py``, "hot swap from
a live training session's checkpoint dir") with a port
``ElasticSession`` training stablelm-3b SMOKE (SGD, k=2, τ=1, 16-token
windows, batch 2) on the CPU and a port ``ContinuousEngine`` watching the
directory it saves into. The engine serves bfloat16 params; the session
saves its float32 master, which the watcher restores onto the engine's
dtypes (``like=engine.params``)."""
import os

import numpy as np
import pytest
import torch

from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.checkpoint import checkpoint
from repro_torch.configs.base import ElasticConfig, OptimizerConfig
from repro_torch.configs.base import get_config
from repro_torch.models.registry import build_model
from repro_torch.nn.param import init_tree, tree_leaves
from repro_torch.serving import (CheckpointWatcher, ContinuousEngine,
                                 Scheduler)
from repro_torch.serving.traffic import TrafficConfig, synthetic_traffic
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _lm_session(save_path, seed=1, rounds=4):
    return ElasticSession(RunSpec(
        arch="stablelm-3b", smoke=True,
        optimizer=OptimizerConfig(name="sgd", lr=0.01),
        elastic=ElasticConfig(num_workers=2, tau=1, dynamic=True),
        rounds=rounds, seed=seed, n_tokens=4000, seq_len=16, batch_size=2,
        save_path=save_path, device="cpu"))


def _engine(**kw):
    model = build_model(get_config("stablelm-3b", smoke=True))
    params = init_tree(torch.Generator().manual_seed(0), model.spec)
    return ContinuousEngine(model, params, **kw)


def _prompt(length, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, length).astype(
        np.int32)


def test_hotswap_tracks_running_session(tmp_path):
    """An engine serving traffic watches the directory a live session
    checkpoints into; a new master landing mid-flight is swapped in
    without dropping the request in flight, and post-swap outputs equal a
    fresh engine's restored from the same checkpoint. The second save is
    forced multi-shard, so the standby restore reassembles shards."""
    ck = str(tmp_path / "ck")
    sess = _lm_session(ck)
    sess.run(2)
    sess.save()

    eng = _engine(capacity=2, max_len=32, prefill_len=8)
    watcher = CheckpointWatcher(eng, ck)
    assert watcher.expect_arch == "stablelm-smoke"
    assert watcher.poll() is False  # the baseline: nothing new

    eng.admit(_prompt(8), max_new=12, rid=0)
    eng.step()
    eng.step()
    pre_swap = [int(t) for t in eng._slots[eng.active_slots()[0]].tokens]

    sess.run(2)  # the session keeps training...
    old = checkpoint.MAX_SHARD_BYTES
    checkpoint.MAX_SHARD_BYTES = 4096
    try:
        sess.save()  # ...and drops a new multi-shard master
    finally:
        checkpoint.MAX_SHARD_BYTES = old
    assert len([f for f in os.listdir(ck) if f.endswith(".npz")]) > 1

    assert watcher.poll() is True
    assert eng.swaps == 1 and watcher.swaps_applied == 1
    assert watcher.log[-1].applied and watcher.log[-1].rounds == 4
    # the engine now serves the session's master, cast to its dtypes
    served = tree_leaves(eng.params)
    assert any(leaf.dtype == torch.bfloat16 for _, leaf in served)
    for (path, got), want in zip(served, sess.layout.views(
            sess.master_params).values()):
        assert torch.equal(got, want.view(got.shape).to(got.dtype)), path

    # the in-flight request was not dropped: it drains to its full budget
    # and its pre-swap tokens are untouched
    done = []
    while eng.num_active:
        done += eng.step()
    (f,) = done
    assert f.rid == 0 and f.tokens.size == 12
    assert [int(t) for t in f.tokens[:len(pre_swap)]] == pre_swap

    # post-swap outputs match a fresh engine restored from the checkpoint
    fresh_params, _ = checkpoint.restore(ck, like=eng.params)
    fresh = ContinuousEngine(eng.model, fresh_params, capacity=2,
                             max_len=32, prefill_len=8)
    p2 = _prompt(6, seed=8)
    eng.admit(p2, max_new=5, rid=1)
    fresh.admit(p2, max_new=5, rid=1)
    got = want = []
    while eng.num_active:
        got = eng.step()
    while fresh.num_active:
        want = fresh.step()
    np.testing.assert_array_equal(got[0].tokens, want[0].tokens)


def test_hotswap_rejects_arch_mismatch(tmp_path):
    """A master saved by a session of another arch (the paper's CNN) is
    journalled and skipped; the served params keep working."""
    ck = str(tmp_path / "ck")
    cnn = ElasticSession(RunSpec(
        arch="paper-cnn", optimizer=OptimizerConfig(name="sgd", lr=0.01),
        elastic=ElasticConfig(num_workers=2, tau=1, dynamic=True),
        rounds=1, seed=0, batch_size=4, n_data=64, n_test=32,
        save_path=ck, device="cpu"))
    model = build_model(get_config("qwen3_4b", smoke=True))
    eng = ContinuousEngine(
        model, init_tree(torch.Generator().manual_seed(0), model.spec),
        capacity=1, max_len=16, prefill_len=8)
    watcher = CheckpointWatcher(eng, ck)  # no directory yet
    cnn.run()  # RunSpec.save_path: saves at the end of the run
    assert watcher.poll() is False
    assert eng.swaps == 0
    (ev,) = watcher.log
    assert not ev.applied and "arch mismatch" in ev.note
    assert watcher.poll() is False  # the same bad checkpoint: not re-read
    assert len(watcher.log) == 1
    eng.admit(_prompt(8), max_new=3)
    while eng.num_active:
        eng.step()


def test_scheduler_polls_watcher(tmp_path):
    """The scheduler's ``poll_every`` cadence drives the watcher: a save
    of the live session landing after the baseline is swapped in during
    the run."""
    ck = str(tmp_path / "ck")
    sess = _lm_session(ck, rounds=2)
    sess.run()  # saves at the end (RunSpec.save_path)
    eng = _engine(capacity=2, max_len=48, prefill_len=8)
    watcher = CheckpointWatcher(eng, ck)
    sess.save()  # lands after the watcher's baseline: the first poll swaps
    sched = Scheduler(eng, watcher=watcher, poll_every=2)
    trace = synthetic_traffic(TrafficConfig(
        num_requests=6, prompt_lens=(4, 8), max_new=16, vocab_size=256,
        seed=5))
    results = sched.run(trace)
    assert len(results) == 6
    assert watcher.swaps_applied == 1
