"""LM training in the port's ``ElasticSession`` against the reference's.

Both sessions train a dense LM at SMOKE width in float32 (the reference's
float32 run is the one a float32 port run can be held to: a bfloat16
reference rounds its workers to bfloat16 every step, the port keeps them
in float32 flat buffers) on the same token stream, overlap batcher and
iid schedule (numpy in both packages). The port starts from the
reference's initial params (``params=``) and its probe seam is fed the
reference's Rademacher probes, rebuilt from the reference's key chain
(``fold_in(key(seed), r)`` → ``split(·, τ)`` → ``split(·, k)`` →
``rademacher_like``). After every round the state and the round's
diagnostics are held to ``tests/test_torch_session.py``'s rules:
diagnostics at rtol 1e-4 / atol 1e-5, the state per leaf norm-wise
within 1e-3 and elementwise within rtol 1e-4 plus 2% of the leaf's scale.

Cases: stablelm-3b SMOKE with AdaHessian and dynamic weighting in both
comm modes, qwen3-4b SMOKE with SGD. Each reference trajectory (three
rounds) is computed once per module and shared by the tests that read it.
Under the trainer's ``vmap(jvp(grad))`` attention takes ``gqa_attention``
at these shapes in both packages.
"""
import copy
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
from repro.optim.hutchinson import rademacher_like
from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.checkpoint import checkpoint
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import get_config as tget
from repro_torch.examples import train_lm_elastic
from repro_torch.launch import train as ttrain
from test_torch_session import (_assert_state_close, _close,
                                one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEED, ROUNDS, K, TAU = 0, 3, 2, 2
CASES = {"stablelm-adahessian-sequential": ("stablelm-3b", "adahessian",
                                            "sequential"),
         "stablelm-adahessian-fused": ("stablelm-3b", "adahessian", "fused"),
         "qwen3-sgd-fused": ("qwen3-4b", "sgd", "fused")}
DIAG = ("u", "score", "h1", "h2", "loss_w")


def _kw(arch, opt, comm, pkg, tau=TAU, rounds=ROUNDS):
    get, Opt, Elastic = ((rget, ROpt, RElastic) if pkg == "ref"
                         else (tget, TOpt, TElastic))
    cfg = get(arch, smoke=True).replace(dtype="float32",
                                        param_dtype="float32")
    return dict(model_cfg=cfg, optimizer=Opt(name=opt, lr=0.01),
                elastic=Elastic(num_workers=K, tau=tau, dynamic=True,
                                comm_mode=comm),
                rounds=rounds, seed=SEED, n_tokens=4000, seq_len=16,
                batch_size=2)


@functools.lru_cache(maxsize=None)
def reference_run(arch, opt, comm, tau=TAU, rounds=ROUNDS):
    """The reference session's initial master, its (τ, k, n) probes, its
    records and state after every round, and its final ``evaluate()``."""
    sess = RSession(RSpec(**_kw(arch, opt, comm, "ref", tau, rounds)))
    params0 = jax.device_get(sess.state["master"])
    flat = jax.jit(lambda key: jnp.concatenate(
        [x.reshape(-1) for x in jax.tree.leaves(
            rademacher_like(key, params0))]))
    probes, records, states = [], [], []
    for r in range(rounds):
        rng = jax.random.fold_in(jax.random.key(SEED), r)
        probes.append(np.stack([np.stack([np.asarray(flat(key)) for key in
                                          jax.random.split(rt, K)])
                                for rt in jax.random.split(rng, tau)]))
        records += sess.run(1)
        states.append(jax.device_get(sess.state))
    return params0, probes, records, states, sess.evaluate()


@functools.lru_cache(maxsize=None)
def port_run(arch, opt, comm, tau=TAU, rounds=ROUNDS):
    """The port's session on the CPU from the reference's params and
    probes: its records, state after every round and final
    ``evaluate()``."""
    params0, probes, _, _, _ = reference_run(arch, opt, comm, tau, rounds)
    sess = ElasticSession(
        RunSpec(**_kw(arch, opt, comm, "port", tau, rounds), device="cpu"),
        params=params0,
        probe_fn=lambda r, t, i: torch.from_numpy(probes[r][t, i])[None])
    records, states = [], []
    for _ in range(rounds):
        records += sess.run(1)
        # a copy: on the CPU some arrays share the live tensors' memory
        states.append(copy.deepcopy(sess.trainer.state_to_numpy(sess.state)))
    return records, states, sess.evaluate()


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_rounds_match_reference(case):
    _, _, want_rec, want_state, _ = reference_run(*CASES[case])
    got_rec, got_state, _ = port_run(*CASES[case])
    assert [r.round for r in got_rec] == list(range(ROUNDS))
    for r, (got, want) in enumerate(zip(got_rec, want_rec)):
        np.testing.assert_array_equal(got.fail, want.fail)
        _close(got.loss, want.loss, f"round {r} loss")
        for key in DIAG:
            _close(getattr(got, key), getattr(want, key),
                   f"round {r} {key}")
        _assert_state_close(got_state[r], want_state[r], f"round {r}")
    # the schedule suppressed some exchange, so h2 was tested at zero too
    assert any(rec.fail.any() for rec in want_rec)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_evaluate_matches_reference(case):
    """An LM has no accuracy: ``evaluate()`` is ``(loss, None)``, the
    master's held-out loss on the ``seed + 31`` batch."""
    want_loss, want_acc = reference_run(*CASES[case])[-1]
    got_loss, got_acc = port_run(*CASES[case])[-1]
    assert got_acc is None and want_acc is None
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)


def test_worker_chunk_gives_the_unchunked_rounds():
    """``RunSpec.worker_chunk`` maps the workers through the local phase's
    transforms a chunk at a time; on the CPU the rounds are bit for bit
    those of one vmapped call over all of them, with AdaHessian and SGD."""
    for opt in ("adahessian", "sgd"):
        kw = dict(_kw("stablelm-3b", opt, "fused", "port"), rounds=2,
                  elastic=TElastic(num_workers=3, tau=2, comm_mode="fused"))
        states = []
        for chunk in (None, 1):
            sess = ElasticSession(RunSpec(**kw, worker_chunk=chunk,
                                          device="cpu"))
            sess.run()
            states.append(sess.state)
        for key in ("workers", "master"):
            assert torch.equal(states[0][key], states[1][key]), (opt, key)
    with pytest.raises(ValueError, match="worker_chunk"):
        RunSpec(worker_chunk=0)


def test_lm_session_saves_a_master_the_engine_accepts(tmp_path):
    """``save`` writes the float32 master with ``{"arch": cfg.name}``;
    ``restore`` reads it back bit for bit, and refuses another arch."""
    sess = ElasticSession(RunSpec(**_kw("qwen3-4b", "sgd", "fused", "port"),
                                  device="cpu"))
    sess.run(1)
    path = sess.save(str(tmp_path / "ck"))
    meta = checkpoint.read_metadata(path)
    assert meta["arch"] == "qwen3-smoke" and meta["rounds"] == 1
    master = sess.master_params.clone()
    sess.run(1)
    sess.restore(path)
    assert torch.equal(sess.master_params, master)
    other = ElasticSession(RunSpec(**_kw("stablelm-3b", "sgd", "fused",
                                         "port"), device="cpu"))
    with pytest.raises(ValueError, match="arch"):
        other.restore(path)


def test_lm_cli_and_example_run_on_the_cpu(tmp_path, capsys):
    """``launch/train.py --arch`` with a dense LM, ``--seq-len`` reaching
    the spec, and ``repro_torch.examples.train_lm_elastic`` on the ci
    preset (two workers, one round) with ``--save``."""
    sess, records = ttrain.main([
        "--arch", "stablelm-3b", "--smoke", "--device", "cpu", "--rounds",
        "2", "--workers", "2", "--seq-len", "16", "--batch-size", "2"])
    assert sess.spec.seq_len == 16 and sess.model_cfg.name == "stablelm-smoke"
    assert sess.batcher.round_batches()["tokens"].shape == (1, 2, 2, 16)
    assert len(records) == 2 and all(np.isfinite(r.loss) for r in records)
    out = capsys.readouterr().out
    assert "round 1: loss=" in out and "h2=" in out
    ck = str(tmp_path / "ck")
    sess, records = train_lm_elastic.main([
        "--device", "cpu", "--preset", "ci", "--workers", "2", "--tau", "1",
        "--rounds", "1", "--eval-every", "1", "--save", ck])
    assert "model: qwen3-ci" in capsys.readouterr().out
    assert sess.spec.seq_len == 128 and sess.spec.batch_size == 8
    assert np.isfinite(records[0].eval_loss) and records[0].eval_acc is None
    meta = checkpoint.read_metadata(ck)
    assert meta["arch"] == "qwen3-ci" and meta["preset"] == "ci"
