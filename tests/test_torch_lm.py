"""The port's dense LM stack against the JAX reference, on the CPU: the
qwen3-4b configs, the spec tree, carried weights (bfloat16 bit for bit),
``multihead_attention`` (full sequence, scalar and per-row vector
``cache_index``), and ``DecoderLM`` forward / prefill / three decode steps.

The shape reaches the flash kernel: qwen3-4b SMOKE with ``head_dim=64``
and 128-token sequences, the reference run with ``use_pallas=True``
(Pallas in interpret mode, as its own tests run it), the port on the CPU
(the kernel's plain version). Tolerances: rtol 1e-4 / atol 1e-5 in
float32 (summation order only); the reference's own 0.08 / 0.08 in
bfloat16 (tests/test_pallas_paths.py), where the two frameworks round at
the same points but their kernels sum in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import qwen3_4b as rq
from repro.configs.base import get_config as rget
from repro.models.registry import build_model as rbuild
from repro.nn import layers as rlayers
from repro.nn.param import init_tree as rinit
from repro.nn.param import param_count as rcount
from repro.nn.param import spec_leaves
from repro_torch.configs import qwen3_4b as tq
from repro_torch.configs.base import get_config as tget
from repro_torch.models.registry import build_model as tbuild
from repro_torch.nn import layers as tlayers
from repro_torch.nn.param import (init_tree, param_count, params_from_numpy,
                                  tree_leaves)

S = 128  # a flash-kernel shape: Sq == Skv == 128
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=0.08, atol=0.08)}


def _cfgs(dtype):
    kw = dict(head_dim=64, dtype=dtype, param_dtype=dtype)
    return (rget("qwen3_4b", smoke=True).replace(use_pallas=True, **kw),
            tget("qwen3_4b", smoke=True).replace(**kw))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request):
    rcfg, tcfg = _cfgs(request.param)
    rmodel, tmodel = rbuild(rcfg), tbuild(tcfg)
    rparams = jax.device_get(rinit(jax.random.key(0), rmodel.spec))
    return request.param, rmodel, tmodel, rparams, params_from_numpy(rparams)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# -- configs, specs, weights -------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_qwen3_configs_match_reference(which):
    got, want = getattr(tq, which), getattr(rq, which)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.kv_heads, got.hd, got.moe) == (want.kv_heads, want.hd,
                                                want.moe)
    assert got.adtype == getattr(torch, str(want.adtype))


@pytest.mark.parametrize("smoke", [False, True])
def test_spec_tree_matches_reference(smoke):
    """Same leaf paths, shapes and dtypes, in the same (sorted) order, at
    full width (4,022,468,096 parameters) and at SMOKE's."""
    rspec = rbuild(rget("qwen3_4b", smoke=smoke)).spec
    tspec = tbuild(tget("qwen3_4b", smoke=smoke)).spec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        rspec, is_leaf=lambda x: hasattr(x, "axes"))
    want = [(tuple(k.key for k in path), s.shape, str(jnp.dtype(s.dtype)))
            for path, s in flat]
    got = [(path, s.shape, str(s.dtype).removeprefix("torch."))
           for path, s in tree_leaves(tspec)]
    assert got == want
    assert param_count(tspec) == rcount(rspec)
    if not smoke:
        assert param_count(tspec) == 4_022_468_096


def test_params_from_numpy_bf16_bits_exact():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 16, (3, 5, 7), dtype=np.uint16)
    bits[0, 0, :4] = [0x7F80, 0xFF80, 0x7FC1, 0x0001]  # ±inf, nan, denormal
    leaf = bits.view(ml_dtypes.bfloat16)
    tree = {"b": {"w": leaf}, "a": np.float32(1.5) * np.ones(2, np.float32)}
    got = params_from_numpy(tree)
    assert got["b"]["w"].dtype == torch.bfloat16
    assert got["a"].dtype == torch.float32
    np.testing.assert_array_equal(
        got["b"]["w"].view(torch.int16).numpy().view(np.uint16), bits)
    back = got["b"]["w"].float().numpy()
    finite = np.isfinite(back)
    np.testing.assert_array_equal(back[finite],
                                  leaf.astype(np.float32)[finite])


def test_init_tree_draws_on_the_generators_device():
    tm = tbuild(tget("qwen3_4b", smoke=True))
    params = init_tree(torch.Generator().manual_seed(0), tm.spec, "cpu")
    leaves = dict(tree_leaves(params))
    for path, spec in tree_leaves(tm.spec):
        assert leaves[path].shape == spec.shape
        assert leaves[path].dtype == spec.dtype
    q_norm = leaves[("dense_layers", "attn", "q_norm")]
    assert torch.equal(q_norm, torch.ones_like(q_norm))
    wq = leaves[("dense_layers", "attn", "wq")].float()
    assert not torch.equal(wq[0], wq[1])  # layers drawn apart
    # fan-in of one layer's (d, H, hd) slice: d = 128
    assert abs(float(wq.std()) - 128 ** -0.5) < 0.01
    with pytest.raises(ValueError, match="generator"):
        init_tree(torch.Generator(), tm.spec, "meta")


# -- attention -------------------------------------------------------------

def _attn_inputs(lm, B, Sq, seed):
    dtype, rmodel, tmodel, rparams, tparams = lm
    rng = np.random.default_rng(seed)
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x = (rng.standard_normal((B, Sq, rmodel.cfg.d_model))).astype(np_dtype)
    tx = params_from_numpy({"x": x})["x"]
    ratt = jax.tree.map(lambda a: a[0], rparams["dense_layers"]["attn"])
    tatt = {k: v[0] for k, v in tparams["dense_layers"]["attn"].items()}
    return jnp.asarray(x), tx, ratt, tatt


def test_attention_full_sequence(lm):
    dtype, rmodel, tmodel = lm[:3]
    x, tx, ratt, tatt = _attn_inputs(lm, 2, S, 0)
    pos = np.broadcast_to(np.arange(S), (2, S))
    rang = rlayers.rope_angles(jnp.asarray(pos), rmodel.cfg)
    tang = tlayers.rope_angles(torch.from_numpy(pos.copy()), tmodel.cfg)
    np.testing.assert_allclose(_np(tang), np.asarray(rang), rtol=1e-6,
                               atol=1e-6)
    want, _ = rlayers.multihead_attention(ratt, x, rmodel.cfg, angles=rang)
    got, _ = tlayers.multihead_attention(tatt, tx, tmodel.cfg, angles=tang)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("index", [5, "vector"])
def test_attention_with_cache(lm, index):
    """Two new tokens per row written into a 16-position cache that
    already holds random K/V, at a scalar offset or per-row offsets."""
    dtype, rmodel, tmodel = lm[:3]
    cfg = rmodel.cfg
    B, Sq, L = 3, 2, 16
    x, tx, ratt, tatt = _attn_inputs(lm, B, Sq, 1)
    rng = np.random.default_rng(2)
    kv = [rng.standard_normal((B, L, cfg.kv_heads, cfg.hd)).astype(
        np.asarray(x).dtype) for _ in range(2)]
    idx = (np.int32(5) if index == 5
           else np.array([[0], [7], [14]], np.int32))
    pos = np.arange(Sq)[None] + idx
    pos = np.broadcast_to(pos, (B, Sq))
    rang = rlayers.rope_angles(jnp.asarray(pos), cfg)
    tang = tlayers.rope_angles(torch.from_numpy(pos.copy()), tmodel.cfg)
    want, rcache = rlayers.multihead_attention(
        ratt, x, cfg, angles=rang, q_pos=jnp.asarray(pos),
        cache={"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])},
        cache_index=jnp.asarray(idx) if index != 5 else int(idx))
    tcache = params_from_numpy({"k": kv[0], "v": kv[1]})
    tidx = torch.from_numpy(idx) if index != 5 else int(idx)
    got, tcache = tlayers.multihead_attention(
        tatt, tx, tmodel.cfg, angles=tang, q_pos=torch.from_numpy(pos.copy()),
        cache=tcache, cache_index=tidx)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(rcache[key]),
                                   **TOL[dtype])


@pytest.mark.parametrize("Sq,cache_len,hd,branch", [
    (128, None, 64, "flash"),    # full sequence, the kernel's shapes
    (128, 128, 64, "flash"),     # prefill into a cache of exactly Sq
    (128, 136, 64, "gqa"),       # prefill into a longer cache: Sq != Skv
    (128, None, 32, "gqa"),      # hd outside {64, 128}
    (64, None, 64, "gqa"),       # Sq % 128 != 0
    (1, 136, 64, "gqa"),         # decode
])
def test_attention_dispatch(monkeypatch, Sq, cache_len, hd, branch):
    """The reference's branch conditions, with the device in place of
    ``use_pallas`` (a CPU tensor on the flash branch runs its plain
    version)."""
    cfg = tget("qwen3_4b", smoke=True).replace(head_dim=hd)
    tm = tbuild(cfg)
    params = init_tree(torch.Generator().manual_seed(0), tm.spec)
    att = {k: v[0] for k, v in params["dense_layers"]["attn"].items()}
    taken = []
    for name in ("flash_attention_bshd", "gqa_attention"):
        fn = getattr(tlayers, name)
        monkeypatch.setattr(tlayers, name, lambda *a, _f=fn, _n=name, **k:
                            taken.append(_n) or _f(*a, **k))
    cache = None
    if cache_len:
        shape = (1, cache_len, cfg.kv_heads, hd)
        cache = {"k": torch.zeros(shape, dtype=cfg.adtype),
                 "v": torch.zeros(shape, dtype=cfg.adtype)}
    x = torch.randn(1, Sq, cfg.d_model, dtype=cfg.adtype)
    out, _ = tlayers.multihead_attention(
        att, x, cfg, cache=cache, cache_index=0 if Sq > 1 else 135)
    assert out.shape == x.shape
    assert taken == [{"flash": "flash_attention_bshd",
                      "gqa": "gqa_attention"}[branch]]


def test_blockwise_branch_raises_by_name():
    _, tcfg = _cfgs("float32")
    tm = tbuild(tcfg.replace(head_dim=32))
    params = init_tree(torch.Generator().manual_seed(0), tm.spec)
    att = {k: v[0] for k, v in params["dense_layers"]["attn"].items()}
    x = torch.zeros(1, 1024, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="blockwise_attention"):
        tlayers.multihead_attention(att, x, tm.cfg)


# -- the model ----------------------------------------------------------------

def test_forward_matches_reference(lm):
    dtype, rmodel, tmodel, rparams, tparams = lm
    toks = _tokens((2, S))
    want, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == tmodel.cfg.adtype and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_prefill_and_three_decode_steps_match_reference(lm):
    """Prefill into a cache of exactly S positions (the flash branch, as
    the continuous engine's admit), then three greedy decode steps on a
    cache of S + 3 positions, each fed the reference's argmax."""
    dtype, rmodel, tmodel, rparams, tparams = lm
    toks = _tokens((2, S), seed=3)
    batch = ({"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)})
    want, _ = jax.jit(rmodel.prefill)(rparams, batch[0],
                                      rmodel.init_cache(2, S))
    got, _ = tmodel.prefill(tparams, batch[1], tmodel.init_cache(2, S))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])

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
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype],
                                   err_msg=f"decode step {i}")
    np.testing.assert_allclose(_np(tcache["dense"]["k"]),
                               _np(rcache["dense"]["k"]), **TOL[dtype])


def test_loss_matches_reference():
    rcfg, tcfg = _cfgs("float32")
    rm, tm = rbuild(rcfg), tbuild(tcfg)
    rparams = jax.device_get(rinit(jax.random.key(1), rm.spec))
    toks, tgts = _tokens((2, S), 4), _tokens((2, S), 5)
    want, _ = rm.loss(rparams, {"tokens": jnp.asarray(toks),
                                "targets": jnp.asarray(tgts)})
    got, parts = tm.loss(params_from_numpy(rparams),
                         {"tokens": torch.from_numpy(toks),
                          "targets": torch.from_numpy(tgts)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(parts["ce"]) == float(got)


def test_unported_families_raise_by_name():
    with pytest.raises(NotImplementedError, match="nn/moe.py"):
        tbuild(tget("qwen3_4b", smoke=True).replace(num_experts=4))
    with pytest.raises(NotImplementedError, match="hybrid"):
        tbuild(tget("qwen3_4b", smoke=True).replace(family="hybrid"))
    smoke = tget("qwen3_4b", smoke=True)
    for kw in (dict(rope_mode="mrope"), dict(norm="layernorm"),
               dict(act="gelu"), dict(tie_embeddings=False)):
        key, val = next(iter(kw.items()))
        with pytest.raises(NotImplementedError, match=f"{key}={val!r}"):
            tbuild(smoke.replace(**kw))
    assert len(spec_leaves(rbuild(rget("qwen3_4b", smoke=True)).spec)) == \
        len(tree_leaves(tbuild(tget("qwen3_4b", smoke=True)).spec))
