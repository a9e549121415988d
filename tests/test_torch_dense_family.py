"""The rest of the dense family against the JAX reference, on the CPU:
stablelm-3b (LayerNorm, a 25% partial rotary, untied unembedding) and
h2o-danube-1.8b (sliding window 4096, untied unembedding).

- both configs, CONFIG and SMOKE, field for field, and their spec trees
  leaf for leaf (full-size parameter counts from the reference's own);
- LayerNorm, the GELU and GeGLU MLPs (and SwiGLU beside them), the untied
  unembedding and the partial rotary at stablelm's head_dim 80 (20
  rotated dims), each against the reference function from shared numpy
  inputs;
- each SMOKE model's ``forward``, and prefill plus three greedy decode
  steps, against the reference's ``DecoderLM`` with carried weights, in
  float32 at 64 tokens: danube-smoke's window of 32 masks inside the
  sequence.

Tolerances are ``tests/test_torch_lm.py``'s: rtol 1e-4 / atol 1e-5 in
float32, 0.08 / 0.08 in bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as rget
from repro.models.registry import build_model as rbuild
from repro.nn import layers as rlayers
from repro.nn.param import init_tree as rinit
from repro.nn.param import param_count as rcount
from repro_torch.configs.base import get_config as tget
from repro_torch.models.registry import build_model as tbuild
from repro_torch.nn import layers as tlayers
from repro_torch.nn.param import param_count, params_from_numpy, tree_leaves
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ["stablelm_3b", "h2o_danube_1_8b"]
FULL_PARAMS = {"stablelm_3b": 2_795_443_200,
               "h2o_danube_1_8b": 1_831_201_280}
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=0.08, atol=0.08)}
S = 64  # > danube-smoke's window of 32


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _pair(a):
    """A numpy array as (jax array, torch tensor), bfloat16 bits carried."""
    return jnp.asarray(a), params_from_numpy({"a": a})["a"]


def _randn(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x if dtype == "float32" else x.astype(ml_dtypes.bfloat16)


# -- configs and spec trees ---------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, smoke):
    got, want = tget(arch, smoke=smoke), rget(arch, smoke=smoke)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.kv_heads, got.hd, got.moe) == (want.kv_heads, want.hd,
                                                want.moe)
    assert got.adtype == getattr(torch, str(want.adtype))
    assert tget(arch.replace("_", "-").replace("1-8b", "1.8b"),
                smoke=smoke) == got


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_reference(arch, smoke):
    """Same leaf paths, shapes and dtypes in the same (sorted) order: the
    LayerNorm ``bias`` leaves and the untied ``embed/unembed`` included."""
    rspec = rbuild(rget(arch, smoke=smoke)).spec
    tspec = tbuild(tget(arch, smoke=smoke)).spec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        rspec, is_leaf=lambda x: hasattr(x, "axes"))
    want = [(tuple(k.key for k in path), s.shape, str(jnp.dtype(s.dtype)))
            for path, s in flat]
    got = [(path, s.shape, str(s.dtype).removeprefix("torch."))
           for path, s in tree_leaves(tspec)]
    assert got == want
    paths = [p for p, _, _ in got]
    assert ("embed", "unembed") in paths
    assert (("dense_layers", "ln1", "bias") in paths) == (arch ==
                                                          "stablelm_3b")
    assert param_count(tspec) == rcount(rspec)
    if not smoke:
        assert param_count(tspec) == FULL_PARAMS[arch]


# -- the layers -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norm_matches_reference(norm, dtype):
    cfg = rget("stablelm_3b", smoke=True).replace(norm=norm)
    tcfg = tget("stablelm_3b", smoke=True).replace(norm=norm)
    d = cfg.d_model
    params = {"scale": 1 + 0.1 * _randn((d,), 1),
              "bias": 0.1 * _randn((d,), 2)}
    if norm == "rmsnorm":
        del params["bias"]
    assert set(params) == set(tlayers.norm_specs(tcfg))
    x = 3 + 2 * _randn((2, 5, d), 0, dtype)  # an offset mean to remove
    rx, tx = _pair(x)
    want = rlayers.apply_norm(jax.tree.map(jnp.asarray, params), rx, cfg)
    got = tlayers.apply_norm(params_from_numpy(params), tx, tcfg)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "geglu", "swiglu"])
def test_mlp_matches_reference(act, dtype):
    """GELU is ``jax.nn.gelu``'s tanh form; the erf form misses float32's
    tolerance here."""
    cfg = rget("stablelm_3b", smoke=True).replace(
        act=act, dtype=dtype, param_dtype=dtype)
    tcfg = tget("stablelm_3b", smoke=True).replace(
        act=act, dtype=dtype, param_dtype=dtype)
    d, f = cfg.d_model, cfg.d_ff
    params = {k: _randn(s.shape, i, dtype) * d ** -0.5 for i, (k, s) in
              enumerate(sorted(tlayers.mlp_specs(tcfg).items()))}
    assert set(params) == set(rlayers.mlp_specs(cfg))
    assert set(params) == ({"wi", "wo"} if act == "gelu"
                           else {"wi_gate", "wi_up", "wo"})
    x = _randn((2, 6, d), 9, dtype)
    rx, tx = _pair(x)
    want = rlayers.apply_mlp(jax.tree.map(jnp.asarray, params), rx, cfg)
    got = tlayers.apply_mlp(params_from_numpy(params), tx, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert params["wo"].shape == (f, d)


@pytest.mark.parametrize("tie", [False, True])
def test_unembed_matches_reference(tie):
    cfg = rget("h2o_danube_1_8b", smoke=True).replace(
        tie_embeddings=tie, dtype="float32", param_dtype="float32")
    tcfg = tget("h2o_danube_1_8b", smoke=True).replace(
        tie_embeddings=tie, dtype="float32", param_dtype="float32")
    spec = tlayers.embedding_specs(tcfg)
    assert set(spec) == set(rlayers.embedding_specs(cfg))
    assert ("unembed" in spec) == (not tie)
    params = {k: 0.02 * _randn(s.shape, i) for i, (k, s) in
              enumerate(sorted(spec.items()))}
    x = _randn((2, 3, cfg.d_model), 7)
    rx, tx = _pair(x)
    want = rlayers.unembed(jax.tree.map(jnp.asarray, params), rx, cfg)
    got = tlayers.unembed(params_from_numpy(params), tx, tcfg)
    assert got.shape == (2, 3, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_partial_rotary_matches_reference():
    """stablelm-3b at full width: head_dim 80, 25% rotary → 20 rotated
    dims; the other 60 pass through unchanged."""
    cfg, tcfg = rget("stablelm_3b"), tget("stablelm_3b")
    assert tlayers._rot_dims(tcfg) == rlayers._rot_dims(cfg) == 20
    pos = np.broadcast_to(np.arange(40) * 7, (2, 40)).astype(np.int32)
    rang = rlayers.rope_angles(jnp.asarray(pos), cfg)
    tang = tlayers.rope_angles(torch.from_numpy(pos.copy()), tcfg)
    assert tang.shape == (2, 40, 10)
    np.testing.assert_allclose(_np(tang), np.asarray(rang), rtol=1e-6,
                               atol=1e-6)
    x = _randn((2, 40, 3, tcfg.hd), 4)
    want = rlayers.apply_rope(jnp.asarray(x), rang, cfg)
    got = tlayers.apply_rope(torch.from_numpy(x), tang, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_array_equal(_np(got)[..., 20:], x[..., 20:])
    assert not np.allclose(_np(got)[:, 1:, :, :20], x[:, 1:, :, :20])


# -- the models -------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    kw = dict(dtype="float32", param_dtype="float32")
    rmodel = rbuild(rget(request.param, smoke=True).replace(**kw))
    tmodel = tbuild(tget(request.param, smoke=True).replace(**kw))
    rparams = jax.device_get(rinit(jax.random.key(0), rmodel.spec))
    return rmodel, tmodel, rparams, params_from_numpy(rparams)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_forward_matches_reference(lm):
    rmodel, tmodel, rparams, tparams = lm
    toks = _tokens((2, S), 0)
    want, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, S, tmodel.cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    if tmodel.cfg.sliding_window:
        # the window masks inside the sequence: the first token reaches
        # layers x (window - 1) positions ahead and no further
        reach = tmodel.cfg.num_layers * (tmodel.cfg.sliding_window - 1)
        assert reach + 1 < S
        other = toks.copy()
        other[:, 0] = (other[:, 0] + 1) % 256
        moved, _ = tmodel.forward(tparams,
                                  {"tokens": torch.from_numpy(other)})
        diff = (moved - got).abs().amax((0, 2))
        assert float(diff[reach]) > 1e-4
        assert float(diff[reach + 1:].max()) == 0.0


def test_prefill_and_three_decode_steps_match_reference(lm):
    """Prefill into a cache of exactly S positions (as the continuous
    engine's admit), then three greedy decode steps on a cache of S + 3,
    each fed the reference's argmax."""
    rmodel, tmodel, rparams, tparams = lm
    toks = _tokens((2, S), 3)
    batch = ({"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)})
    want, _ = jax.jit(rmodel.prefill)(rparams, batch[0],
                                      rmodel.init_cache(2, S))
    got, _ = tmodel.prefill(tparams, batch[1], tmodel.init_cache(2, S))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])

    rcache, tcache = rmodel.init_cache(2, S + 3), tmodel.init_cache(2, S + 3)
    want, rcache = rmodel.prefill(rparams, batch[0], rcache)
    got, tcache = tmodel.prefill(tparams, batch[1], tcache)
    step = jax.jit(rmodel.decode_step)
    for i in range(3):
        tok = np.asarray(jnp.argmax(want[:, -1:], -1)).astype(np.int32)
        want, rcache = step(rparams, {"tokens": jnp.asarray(tok)}, rcache,
                            S + i)
        got, tcache = tmodel.decode_step(
            tparams, {"tokens": torch.from_numpy(tok)}, tcache, S + i)
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"],
                                   err_msg=f"decode step {i}")
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["dense"][key]),
                                   _np(rcache["dense"][key]),
                                   **TOL["float32"])
