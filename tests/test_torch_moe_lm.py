"""The MoE decoder LMs against the JAX reference, and the MoE serving and
training entry points, on the CPU.

- each SMOKE model (mixtral-smoke: top-2 of 4 experts, window 32;
  llama4-scout-smoke: top-1 of 4 with a shared expert, chunk 32;
  moonshot-smoke: a first dense layer, then top-2 of 4 with a shared
  expert) in float32 at 64 tokens with the reference's weights: its
  ``forward`` logits and router aux, prefill plus three greedy decode
  steps (both cache stacks, at atol 1e-5 of the cache's scale: K is
  stored after RoPE), and ``loss`` with the aux weighed in;
- on moonshot-smoke the continuous engine equals the port's
  ``ServeEngine`` token for token on an all-at-t0 batch;
- ``launch/serve.py --arch mixtral-8x22b --traffic 2`` and
  ``launch/train.py --arch moonshot-v1-16b-a3b --smoke --rounds 1`` run.

Tolerances: rtol 1e-4 / atol 1e-5 (``tests/test_torch_lm.py``'s float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as rget
from repro.models.registry import build_model as rbuild
from repro.nn.param import init_tree as rinit
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import build_model as tbuild
from repro_torch.nn.param import init_tree, params_from_numpy
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import ServeEngine
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ["mixtral_8x22b", "llama4_scout_17b_a16e", "moonshot_v1_16b_a3b"]
TOL = dict(rtol=1e-4, atol=1e-5)
S = 64  # > the SMOKE configs' window and chunk of 32


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    kw = dict(dtype="float32", param_dtype="float32")
    rmodel = rbuild(rget(request.param, smoke=True).replace(**kw))
    tmodel = tbuild(tget(request.param, smoke=True).replace(**kw))
    rparams = jax.device_get(rinit(jax.random.key(0), rmodel.spec))
    return rmodel, tmodel, rparams, params_from_numpy(rparams)


def test_moe_forward_matches_reference(lm):
    rmodel, tmodel, rparams, tparams = lm
    toks = _tokens((2, S), 0)
    want, want_aux = jax.jit(rmodel.forward)(rparams,
                                             {"tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, S, tmodel.cfg.vocab_size)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    # one aux per MoE layer, each >= 1 for a router that is not uniform
    assert float(aux) >= tmodel.n_moe * (1 - 1e-5)


def test_moe_prefill_and_three_decode_steps_match_reference(lm):
    """Prefill into a cache of exactly S positions (an admit), then three
    greedy decode steps on a cache of S + 3, each fed the reference's
    argmax; both cache stacks at the end."""
    rmodel, tmodel, rparams, tparams = lm
    toks = _tokens((2, S), 3)
    batch = ({"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)})
    prefill = jax.jit(rmodel.prefill)
    want, _ = prefill(rparams, batch[0], rmodel.init_cache(2, S))
    got, _ = tmodel.prefill(tparams, batch[1], tmodel.init_cache(2, S))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)

    rcache, tcache = rmodel.init_cache(2, S + 3), tmodel.init_cache(2, S + 3)
    assert sorted(tcache) == sorted(rcache)
    want, rcache = prefill(rparams, batch[0], rcache)
    got, tcache = tmodel.prefill(tparams, batch[1], tcache)
    step = jax.jit(rmodel.decode_step)
    for i in range(3):
        tok = np.asarray(jnp.argmax(want[:, -1:], -1)).astype(np.int32)
        want, rcache = step(rparams, {"tokens": jnp.asarray(tok)}, rcache,
                            S + i)
        got, tcache = tmodel.decode_step(
            tparams, {"tokens": torch.from_numpy(tok)}, tcache, S + i)
        np.testing.assert_allclose(_np(got), _np(want), **TOL,
                                   err_msg=f"decode step {i}")
    # the cache holds K after RoPE: float32 angles at positions up to 66
    # are good to ~4e-6 rad, so K (|K| up to ~4.5) is held at atol 1e-5
    # of its scale
    for part in tcache:
        for key in ("k", "v"):
            want = _np(rcache[part][key])
            np.testing.assert_allclose(_np(tcache[part][key]), want,
                                       rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max())


def test_moe_loss_matches_reference(lm):
    """``loss`` = cross-entropy + ``router_aux_weight`` x aux in both."""
    rmodel, tmodel, rparams, tparams = lm
    toks, tgts = _tokens((2, S), 4), _tokens((2, S), 5)
    want, want_parts = jax.jit(rmodel.loss)(
        rparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    got, parts = tmodel.loss(tparams, {"tokens": torch.from_numpy(toks),
                                       "targets": torch.from_numpy(tgts)})
    np.testing.assert_allclose(float(got), float(want), **TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[key]),
                                   float(want_parts[key]), **TOL)
    np.testing.assert_allclose(
        float(got), float(parts["ce"]) + 0.01 * float(parts["aux"]),
        rtol=1e-6)


def test_moe_continuous_engine_equals_serve_engine():
    """moonshot-smoke (bfloat16, its dense layer and two MoE layers), all
    requests at t=0 with one prompt length: admits at batch 1 and pooled
    decode ticks give the static batch's tokens exactly."""
    model = tbuild(tget("moonshot-v1-16b-a3b", smoke=True))
    params = init_tree(torch.Generator().manual_seed(0), model.spec)
    prompts = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (3, 8)).astype("int32")
    want = ServeEngine(model, params, max_len=64).generate(prompts, steps=10)
    eng = ContinuousEngine(model, params, capacity=3, max_len=64,
                           prefill_len=8)
    assert sorted(eng.cache) == ["dense", "moe"]
    for i in range(3):
        eng.admit(prompts[i], max_new=10, rid=i)
    done = []
    while eng.num_active:
        done += eng.step()
    got = np.stack([f.tokens for f in sorted(done, key=lambda f: f.rid)])
    np.testing.assert_array_equal(got, want)
    assert all(f.reason == "length" for f in done)


def test_moe_serve_and_train_clis_on_the_cpu(capsys):
    tserve.main(["--device", "cpu", "--arch", "mixtral-8x22b", "--traffic",
                 "2", "--steps", "4", "--prompt-len", "16"])
    out = capsys.readouterr().out
    assert "serving mixtral-smoke" in out
    assert "served 2/2 requests, 8 tokens" in out
    sess, records = ttrain.main([
        "--device", "cpu", "--arch", "moonshot-v1-16b-a3b", "--smoke",
        "--rounds", "1", "--workers", "2", "--seq-len", "16",
        "--batch-size", "2"])
    assert sess.model_cfg.name == "moonshot-smoke"
    assert any(n.startswith("moe_layers.moe.router") for n in
               sess.layout.names)
    assert len(records) == 1 and np.isfinite(records[0].loss)
    assert "round 0: loss=" in capsys.readouterr().out
