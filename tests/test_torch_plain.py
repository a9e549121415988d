"""The k=1 plain control against the JAX reference: the single-worker
AdaHessian kernel's plain version against the Pallas
``adahessian_update_flat`` it replaces (``adahessian_step_pallas``, jit,
``interpret=True``) at the reference's tolerance (rtol 2e-5, atol 2e-6,
tests/test_kernels.py), and ``RunSpec.plain`` sessions of both packages
over three steps from the reference's init with its own Rademacher probes
(``fold_in(key(seed), step)`` → ``rademacher_like``) injected through the
port's probe seam, at the ROADMAP's state tolerances (``run_parity`` in
tests/test_torch_session.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import ElasticSession as RSession
from repro.api.session import RunSpec as RSpec
from repro.configs.base import OptimizerConfig as ROpt
from repro.kernels.adahessian.ops import adahessian_step_pallas
from repro.kernels.adahessian.ops import pack_scalars as rpack
from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.core.scenarios import ScenarioSchedule
from repro_torch.kernels import kernels
from repro_torch.kernels.adahessian import ops as tada
from repro_torch.nn.param import tree_leaves
from test_torch_session import (_close, _leaf_close, _worker_probe,
                                one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEED, STEPS = 0, 3


@pytest.mark.parametrize("n", [1001, 65537])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("power", [1.0, 0.5])
def test_flat_step_plain_matches_pallas(n, t, power):
    """Odd n (the Pallas wrapper pads to 256×128 tiles; the port masks)."""
    kw = dict(name="adahessian", lr=0.02, hessian_power=power)
    rng = np.random.default_rng(n + t)
    p, g, h, m = (rng.standard_normal(n).astype(np.float32)
                  for _ in range(4))
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    step = jax.jit(functools.partial(adahessian_step_pallas, cfg=ROpt(**kw),
                                     interpret=True))
    want = step(p, g, h, m, v, t=jnp.int32(t))
    scalars = tada.pack_scalars(TOpt(**kw), torch.tensor(t, dtype=torch.int32))
    np.testing.assert_array_equal(
        scalars.numpy(), np.asarray(rpack(ROpt(**kw), jnp.int32(t))))
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    before = kernels()["adahessian_update_flat"].launches
    tada.adahessian_step(tp, torch.from_numpy(g), torch.from_numpy(h), tm, tv,
                         scalars)
    # a CPU tensor takes the plain version: no launch is counted
    assert kernels()["adahessian_update_flat"].launches == before
    for got, w in zip((tp, tm, tv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-6)


def test_flat_step_checks_its_inputs():
    x = torch.zeros(5)
    s = torch.zeros(7)
    with pytest.raises(ValueError, match="scalars"):
        tada.adahessian_step(x, x, x, x, x, torch.zeros(6))
    with pytest.raises(ValueError, match="shape"):
        tada.adahessian_step(x, x, torch.zeros(4), x, x, s)
    with pytest.raises(TypeError, match="float32"):
        tada.adahessian_step(x.double(), x, x, x, x, s)


def _plain_kw(**kw):
    base = dict(plain=True, rounds=STEPS, batch_size=4, n_data=200,
                n_test=16, seed=SEED, eval_every=1)
    base.update(kw)
    return base


@pytest.mark.parametrize("opt", [
    dict(name="adahessian"), dict(name="adahessian", weight_decay=1e-3),
    dict(name="adam", lr=1e-4)])
def test_plain_session_matches_reference(opt):
    """AdaHessian runs the single-worker kernel's plain version (with
    weight decay, the batched kernel's at k=1); Adam its elementwise
    step. Losses, held-out metrics, params and optimizer state agree.

    Adam's first step is lr·g/(|g| + ε): where a gradient element sits at
    rounding level the two frameworks can disagree on its sign (measured:
    one fc1 weight of 1,179,648 with g = 1.2e-8 here, −1.8e-8 in the
    reference), and that element moves by ±lr. At lr 1e-3 that single
    element exceeds the elementwise bound (2% of fc1's scale, 1.1e-3);
    lr 1e-4 keeps it inside, and Adam's arithmetic itself is held at the
    kernel tolerance on shared gradients by
    tests/test_torch_model_optim.py::test_optimizer_steps_match."""
    ref = RSession(RSpec(optimizer=ROpt(**opt), **_plain_kw()))
    params = jax.device_get(ref.state["params"])
    want = ref.run()
    one = _worker_probe()
    probe = lambda r, t, i: torch.from_numpy(np.asarray(one(
        jax.random.fold_in(jax.random.key(SEED), r))))[None]
    sess = ElasticSession(RunSpec(optimizer=TOpt(**opt), device="cpu",
                                  **_plain_kw()),
                          params=params, probe_fn=probe)
    got = sess.run()
    assert [r.round for r in got] == [r.round for r in want]
    for key in ("loss", "eval_loss", "eval_acc"):
        _close([getattr(r, key) for r in got], [getattr(r, key) for r in want],
               key)
    rstate = jax.device_get(ref.state)
    tparams = sess.layout.to_numpy(sess.state["params"])
    for path, leaf in tree_leaves(rstate["params"]):
        _leaf_close(dict(tree_leaves(tparams))[path], leaf, f"params {path}")
    assert int(sess.state["opt"]["count"]) == int(rstate["opt"]["count"])
    for key in set(rstate["opt"]) - {"count"}:
        tree = sess.layout.to_numpy(sess.state["opt"][key])
        for path, leaf in tree_leaves(rstate["opt"][key]):
            _leaf_close(dict(tree_leaves(tree))[path], leaf,
                        f"opt/{key}/{path}")
    assert sess.state["step"] == int(rstate["step"]) == STEPS


def test_plain_mode_forces_the_k1_control_and_refuses_lm_training():
    """Plain mode is the k=1 control for the CNN and for a dense LM alike
    (LM training is ported: an LM in plain mode runs one optimizer step a
    round on the token stream, and its eval has no accuracy); an MoE arch
    builds; an arch the port lacks is still refused by name, in plain mode
    and not."""
    from repro_torch.configs.base import ElasticConfig, get_config

    sess = ElasticSession(RunSpec(
        elastic=ElasticConfig(num_workers=8, tau=4, failure_prob=0.5,
                              failure_scenario="byzantine"),
        device="cpu", **_plain_kw(rounds=1)))
    e = sess.ecfg
    assert (e.cap, e.tau, e.failure_prob, e.overlap_ratio,
            e.membership_scenario) == (1, 1, 0.0, 0.0, "static")
    assert sess.schedule is None
    rec = sess.run()[0]
    assert rec.u.shape == (1,) and rec.loss_w is None and not rec.fail.any()
    with pytest.raises(ValueError, match="plain"):
        z = np.zeros((1, 1), bool)
        RunSpec(schedule=ScenarioSchedule(z, z, z), **_plain_kw(rounds=1))
    lm = ElasticSession(RunSpec(
        model_cfg=get_config("qwen3-4b", smoke=True),
        elastic=ElasticConfig(num_workers=4, tau=2), device="cpu",
        **_plain_kw(rounds=2, batch_size=2, seq_len=16, n_tokens=2000)))
    assert (lm.ecfg.cap, lm.ecfg.tau, lm.schedule) == (1, 1, None)
    assert lm.batcher.round_batches()["tokens"].shape == (1, 1, 2, 16)
    recs = lm.run()
    assert [r.round for r in recs] == [0, 1] and lm.state["step"] == 2
    assert all(np.isfinite(r.loss) and r.eval_acc is None
               and np.isfinite(r.eval_loss) for r in recs)
    for plain in (True, False):
        for arch, match in (("rwkv6-3b", "rwkv6-3b"),
                            ("seamless-m4t-large-v2", "seamless-smoke.*'src'")):
            with pytest.raises(NotImplementedError, match=match):
                ElasticSession(RunSpec(arch=arch, smoke=True, device="cpu",
                                       **_plain_kw(plain=plain, rounds=1)))
    moe = ElasticSession(RunSpec(
        arch="moonshot-v1-16b-a3b", smoke=True, device="cpu",
        **_plain_kw(rounds=1, batch_size=2, seq_len=16, n_tokens=2000)))
    assert moe.ecfg.cap == 1 and moe.model.n_moe == 2
