"""The mixture-of-experts layer and configs against the JAX reference, on
the CPU.

- mixtral-8x22b, llama4-scout-17b-a16e and moonshot-v1-16b-a3b, CONFIG
  and SMOKE, field for field, and their spec trees leaf for leaf (the
  float32 router included; full-size parameter counts from the
  reference's own);
- ``apply_moe`` against the reference's ``apply_moe`` from shared numpy
  inputs and carried weights: ``tests/test_moe.py``'s four (E, K, shared)
  cases with nothing dropped (and the port's dense oracle beside them), a
  capacity factor of 0.5 where slots drop (the same kept slots, the same
  aux), a zero router (every probability tied: the lower expert index
  wins, as ``jax.lax.top_k`` breaks ties), bfloat16, and the gradient of
  ``sum(y**2) + 0.01 * aux``; the dropped slots' dump row never reaches
  an output.

Tolerances: rtol 1e-4 / atol 1e-5 in float32 (``tests/test_moe.py``),
2e-2 in bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RConfig
from repro.configs.base import get_config as rget
from repro.models.registry import build_model as rbuild
from repro.nn import moe as rmoe
from repro.nn.param import init_tree as rinit
from repro.nn.param import param_count as rcount
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.configs.base import get_config as tget
from repro_torch.models.registry import build_model as tbuild
from repro_torch.nn import moe as tmoe
from repro_torch.nn.param import param_count, params_from_numpy, tree_leaves
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ["mixtral_8x22b", "llama4_scout_17b_a16e", "moonshot_v1_16b_a3b"]
FULL_PARAMS = {"mixtral_8x22b": 140_630_071_296,
               "llama4_scout_17b_a16e": 107_769_861_120,
               "moonshot_v1_16b_a3b": 28_386_592_768}
TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(E=4, K=2, cf=8.0, shared=0, dtype="float32"):
    """``tests/test_moe.py``'s layer config, in both packages."""
    kw = dict(name="t", family="moe", num_layers=1, d_model=32, num_heads=4,
              d_ff=64, vocab_size=64, num_experts=E, top_k=K,
              expert_d_ff=48, capacity_factor=cf, num_shared_experts=shared,
              dtype=dtype, param_dtype=dtype)
    return RConfig(**kw), TConfig(**kw)


def _layer(E=4, K=2, cf=8.0, shared=0, dtype="float32", S=16, seed=0):
    """Both configs, the reference's params (numpy), the port's, and one
    (2, S, 32) input as (jax, torch)."""
    rcfg, tcfg = _cfgs(E, K, cf, shared, dtype)
    params = jax.device_get(rinit(jax.random.key(seed), rmoe.moe_specs(rcfg)))
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, S, 32)).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    return (rcfg, tcfg, params, params_from_numpy(params), jnp.asarray(x),
            params_from_numpy({"x": x})["x"])


def _jit(fn, cfg):
    """A reference function jitted at one config (one compile, where eager
    JAX compiles every primitive)."""
    return jax.jit(lambda *a: fn(*a, cfg))


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _ref_top_e(rp, rx, K):
    """The reference's chosen experts (``moe.py:72-77``)."""
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", rx.astype(jnp.float32),
                                      rp["router"]), -1)
    return jax.lax.top_k(probs, K)[1]


def _kept_slots(top_e, E, C):
    """The (row, slot) pairs kept under capacity C, from (B, S, K) expert
    ids: numpy's own count of each row's slots in token-major order."""
    B = top_e.shape[0]
    slots = np.asarray(top_e).reshape(B, -1)
    keep = np.zeros(slots.shape, bool)
    for b in range(B):
        seen = np.zeros(E, int)
        for t, e in enumerate(slots[b]):
            keep[b, t] = seen[e] < C
            seen[e] += 1
    return keep


# -- configs and spec trees ---------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_match_reference(arch, smoke):
    got, want = tget(arch, smoke=smoke), rget(arch, smoke=smoke)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.kv_heads, got.hd, got.moe, got.e_dff) == (
        want.kv_heads, want.hd, want.moe, want.e_dff)
    assert got.family == "moe" and got.moe
    assert tget(arch.replace("_", "-"), smoke=smoke) == got


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_spec_tree_matches_reference(arch, smoke):
    """Same leaf paths, shapes and dtypes in the same (sorted) order: the
    router float32 in a bfloat16 model, the shared experts, moonshot's
    first dense layer in ``dense_layers``."""
    rmodel, tmodel = rbuild(rget(arch, smoke=smoke)), tbuild(tget(arch,
                                                                smoke=smoke))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        rmodel.spec, is_leaf=lambda x: hasattr(x, "axes"))
    want = [(tuple(k.key for k in path), s.shape, str(jnp.dtype(s.dtype)))
            for path, s in flat]
    got = [(path, s.shape, str(s.dtype).removeprefix("torch."))
           for path, s in tree_leaves(tmodel.spec)]
    assert got == want
    dtypes = dict((p, d) for p, _, d in got)
    assert dtypes[("moe_layers", "moe", "router")] == "float32"
    assert dtypes[("moe_layers", "moe", "wi_gate")] == "bfloat16"
    cfg = tmodel.cfg
    assert (("moe_layers", "moe", "shared", "wo") in dtypes) == bool(
        cfg.num_shared_experts)
    assert (tmodel.n_dense, tmodel.n_moe) == (rmodel.n_dense, rmodel.n_moe)
    assert (tmodel.n_dense, tmodel.n_moe) == (
        cfg.first_dense_layers, cfg.num_layers - cfg.first_dense_layers)
    assert param_count(tmodel.spec) == rcount(rmodel.spec)
    if not smoke:
        assert param_count(tmodel.spec) == FULL_PARAMS[arch]
    cache = tmodel.cache_spec(2, 8)
    assert sorted(cache) == (["dense", "moe"] if cfg.first_dense_layers
                             else ["moe"])
    assert cache["moe"]["k"].shape == (tmodel.n_moe, 2, 8, cfg.kv_heads,
                                       cfg.hd)


def test_moe_depth_cuts_give_the_card_phases_param_counts():
    """The card's cut models: mixtral and scout at full width, 2 layers;
    moonshot at 2 layers (1 dense + 1 MoE) in float32."""
    for arch, n, want in (("mixtral_8x22b", 2, 5_410_781_184),
                          ("llama4_scout_17b_a16e", 2, 6_473_180_160),
                          ("moonshot_v1_16b_a3b", 2, 1_344_940_032)):
        cfg = tget(arch).replace(num_layers=n)
        assert param_count(tbuild(cfg).spec) == want == rcount(
            rbuild(rget(arch).replace(num_layers=n)).spec)


@pytest.mark.parametrize("S,cf", [(1, 1.25), (16, 8.0), (64, 0.5),
                                  (512, 1.25), (12288, 1.25), (37, 2.0)])
def test_capacity_matches_reference(S, cf):
    for E, K in ((4, 2), (8, 2), (16, 1), (64, 6)):
        rcfg, tcfg = _cfgs(E=E, K=K, cf=cf)
        C = tmoe._capacity(S, tcfg)
        assert C == rmoe._capacity(S, rcfg)
        assert C % 8 == 0 and C >= K


# -- the layer ----------------------------------------------------------------

@pytest.mark.parametrize("E,K,shared", [(4, 1, 0), (4, 2, 0), (8, 2, 1),
                                        (8, 6, 2)])
def test_dispatch_matches_reference(E, K, shared):
    """Capacity factor E: nothing drops. The port equals the reference's
    ``apply_moe`` and its own dense oracle, which equals the reference's."""
    rcfg, tcfg, rp, tp, rx, tx = _layer(E=E, K=K, cf=float(E), shared=shared)
    want_y, want_aux = _jit(rmoe.apply_moe, rcfg)(rp, rx)
    got_y, got_aux = tmoe.apply_moe(tp, tx, tcfg)
    assert got_y.dtype == torch.float32 and got_aux.dtype == torch.float32
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    dense = tmoe.moe_ref_dense(tp, tx, tcfg)
    np.testing.assert_allclose(_np(dense), _np(got_y), **TOL)
    np.testing.assert_allclose(_np(dense),
                               _np(_jit(rmoe.moe_ref_dense, rcfg)(rp, rx)),
                               **TOL)
    assert float(got_aux) > 0


def test_drops_match_reference():
    """Capacity factor 0.5 at 64 tokens, E=4, K=2: C=16 of each row's 128
    slots per expert, so slots drop. The same slots are kept (counted in
    numpy from each package's chosen experts), the outputs agree, and so
    does the aux."""
    rcfg, tcfg, rp, tp, rx, tx = _layer(E=4, K=2, cf=0.5, S=64)
    C = tmoe._capacity(64, tcfg)
    assert C == 16
    want_e = _ref_top_e(rp, rx, 2)
    _, _, got_e = tmoe.route(tp, tx, tcfg)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    keep = _kept_slots(got_e.numpy(), 4, C)
    assert 0 < keep.sum() < keep.size
    want_y, want_aux = _jit(rmoe.apply_moe, rcfg)(rp, rx)
    got_y, got_aux = tmoe.apply_moe(tp, tx, tcfg)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    # a token whose slots were all dropped gets nothing from the experts
    dropped = ~keep.reshape(2, 64, 2).any(-1)
    assert dropped.any()
    np.testing.assert_array_equal(_np(got_y)[dropped], 0.0)
    assert float((got_y - tmoe.moe_ref_dense(tp, tx, tcfg)).abs().max()) > 1e-4


def test_dump_row_never_reaches_an_output(monkeypatch):
    """The dropped slots' dump row (row E of the scatter) is discarded:
    filled with NaN, it changes no output and no gradient."""
    rcfg, tcfg, rp, tp, rx, tx = _layer(E=4, K=2, cf=0.5, S=64)
    want_y, want_aux = tmoe.apply_moe(tp, tx, tcfg)
    scatter = tmoe._scatter

    def poisoned(xk, idx_e, idx_c, E, C):
        buf = scatter(xk, idx_e, idx_c, E, C)
        assert bool((idx_e == E).any())  # slots did drop
        return torch.cat([buf[:, :E], torch.full_like(buf[:, E:],
                                                      float("nan"))], 1)

    def loss(p):
        y, aux = tmoe.apply_moe(p, tx, tcfg)
        return (y ** 2).sum() + 0.01 * aux

    want_g = torch.func.grad(loss)(tp)
    monkeypatch.setattr(tmoe, "_scatter", poisoned)
    got_y, got_aux = tmoe.apply_moe(tp, tx, tcfg)
    assert torch.equal(got_y, want_y) and torch.equal(got_aux, want_aux)
    got_g = torch.func.grad(loss)(tp)
    for (path, a), (_, b) in zip(tree_leaves(got_g), tree_leaves(want_g)):
        assert torch.equal(a, b), path


def test_zero_router_ties_go_to_the_lower_expert():
    """A zero router makes every probability 1/E: the reference's top-k
    picks experts 0..K-1, so top-1 is expert 0 for every token and the aux
    is E * (1 * 1/E) = 1. ``torch.topk`` picks others; the port does
    not."""
    for E, K in ((4, 1), (8, 2), (8, 6)):
        rcfg, tcfg, rp, tp, rx, tx = _layer(E=E, K=K, cf=float(E), S=32)
        rp["router"] = np.zeros_like(rp["router"])
        tp["router"] = torch.zeros_like(tp["router"])
        _, _, got_e = tmoe.route(tp, tx, tcfg)
        want_e = _ref_top_e(rp, rx, K)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(got_e.numpy()[0, 0], np.arange(K))
        want_y, want_aux = _jit(rmoe.apply_moe, rcfg)(rp, rx)
        got_y, got_aux = tmoe.apply_moe(tp, tx, tcfg)
        assert float(got_aux) == float(want_aux)
        np.testing.assert_allclose(float(got_aux), 1.0, rtol=1e-6)
        np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)


@pytest.mark.parametrize("E,K,shared", [(4, 2, 0), (8, 6, 2)])
def test_bf16_dispatch_matches_reference(E, K, shared):
    """bfloat16 params and activations, the router float32: 2e-2, at the
    default capacity factor (slots drop at E=4) and with nothing dropped."""
    for cf in (1.25, float(E)):
        rcfg, tcfg, rp, tp, rx, tx = _layer(E=E, K=K, cf=cf, shared=shared,
                                            dtype="bfloat16", S=32)
        assert tp["router"].dtype == torch.float32
        assert tp["wi_gate"].dtype == torch.bfloat16
        want_y, want_aux = _jit(rmoe.apply_moe, rcfg)(rp, rx)
        got_y, got_aux = tmoe.apply_moe(tp, tx, tcfg)
        assert got_y.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got_y), _np(want_y), rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(float(got_aux), float(want_aux),
                                   rtol=2e-2)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_grad_matches_reference(cf):
    """``torch.func.grad`` of ``sum(y**2) + 0.01 * aux`` against
    ``jax.grad`` (``tests/test_moe.py``'s loss), every leaf, with shared
    experts, with and without drops."""
    rcfg, tcfg, rp, tp, rx, tx = _layer(E=8, K=2, cf=cf, shared=1, S=32)

    def rloss(p):
        y, aux = rmoe.apply_moe(p, rx, rcfg)
        return jnp.sum(y ** 2) + 0.01 * aux

    def tloss(p):
        y, aux = tmoe.apply_moe(p, tx, tcfg)
        return (y ** 2).sum() + 0.01 * aux

    want = dict(tree_leaves(jax.device_get(jax.jit(jax.grad(rloss))(rp))))
    got = tree_leaves(torch.func.grad(tloss)(tp))
    assert [p for p, _ in got] == sorted(want)
    for path, g in got:
        np.testing.assert_allclose(_np(g), want[path], **TOL,
                                   err_msg="/".join(path))
    assert float(sum(g.abs().sum() for _, g in got)) > 0
