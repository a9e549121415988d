"""The port's encoder-decoder family (seamless-m4t-large-v2) and its
attention against the JAX reference, on the CPU.

- ``multihead_attention`` non-causal (the encoder's self-attention) and
  cross (keys and values from ``kv_x``, or the ``kv_precomputed`` pair;
  no rope, no q/k norm, never causal) against the reference's, with the
  port's branch checked: ``gqa_attention`` at SMOKE's head_dim 32, the
  flash branch non-causal at head_dim 64 with Sq == Skv == 128 (self and
  cross; the reference with ``use_pallas=True``, Pallas in interpret
  mode; the port the kernel's plain version), and blockwise attention
  non-causal at 1024 tokens.
- ``EncDecLM`` at SMOKE, the same weights and inputs in both packages:
  ``forward``, ``loss``, ``prefill`` (the memory's cross K/V replace the
  cache's) and three decode steps, in float32 (rtol 1e-4 / atol 1e-5)
  and bfloat16 (``tests/test_torch_lm.py``'s ``TOL``), and once at
  head_dim 64 with 128 frames and 128 tokens (the encoder, the decoder's
  self-attention and its cross-attention on the flash branch).
- ``ServeEngine.generate`` with ``extra_batch={"src": ...}``: greedy tokens
  equal to the reference's (float32, no near-tie at any generated
  position); the serving CLI and ``examples/serve_batch.py``, which make
  no frames, raise naming ``src`` (the reference's fail with
  ``KeyError: 'src'``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import seamless_m4t_large_v2 as rq
from repro.configs.base import get_config as rget
from repro.models.registry import build_model as rbuild
from repro.nn import layers as rlayers
from repro.nn.param import init_tree as rinit
from repro.nn.param import param_count as rcount
from repro.serving.engine import ServeEngine as RServe
from repro_torch.configs import seamless_m4t_large_v2 as tq
from repro_torch.configs.base import get_config as tget
from repro_torch.examples import serve_batch
from repro_torch.launch import serve as tserve
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import build_model as tbuild
from repro_torch.nn import layers as tlayers
from repro_torch.nn.param import param_count, params_from_numpy
from repro_torch.serving.engine import ServeEngine
from test_torch_lm import TOL, _np
from test_torch_session import one_torch_thread  # noqa: F401
from test_torch_vlm import spec_paths

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, SE, ST = 2, 24, 16  # batch, source frames, target tokens at SMOKE


def _np_dtype(dtype):
    return np.float32 if dtype == "float32" else ml_dtypes.bfloat16


def _watch(monkeypatch):
    """The port's attention branches taken, in order, with the causal flag
    each was given."""
    taken = []
    for name in ("flash_attention_bshd", "blockwise_attention",
                 "gqa_attention"):
        fn = getattr(tlayers, name)
        monkeypatch.setattr(tlayers, name, lambda *a, _f=fn, _n=name, **k:
                            taken.append((_n, k.get("causal"))) or
                            _f(*a, **k))
    return taken


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_seamless_configs_and_specs_match_reference(which):
    """Field for field, and the same spec tree (the cross blocks without
    q/k norms) and parameter count: 2,034,784,256 at full size."""
    got, want = getattr(tq, which), getattr(rq, which)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    tmodel = tbuild(got)
    assert isinstance(tmodel, EncDecLM)
    got_paths, want_paths = spec_paths(rbuild(want).spec, tmodel.spec)
    assert got_paths == want_paths
    assert param_count(tmodel.spec) == rcount(rbuild(want).spec)
    if which == "CONFIG":
        assert param_count(tmodel.spec) == 2_034_784_256
    qk = got.replace(qk_norm=True)
    assert "q_norm" in tlayers.attention_specs(qk)
    assert "q_norm" not in tlayers.attention_specs(qk, cross=True)


# -- attention -------------------------------------------------------------------

# case: (head_dim, Sq, Skv, kind, branch); kind "self" is non-causal
ATTN = {"self-gqa": (32, 24, 24, "self", "gqa_attention"),
        "cross-gqa": (32, 24, 40, "kv_x", "gqa_attention"),
        "precomputed-gqa": (32, 3, 40, "kv_precomputed", "gqa_attention"),
        "self-flash": (64, 128, 128, "self", "flash_attention_bshd"),
        "cross-flash": (64, 128, 128, "kv_x", "flash_attention_bshd"),
        "self-blockwise": (32, 1024, 1024, "self", "blockwise_attention")}


@pytest.mark.parametrize("case,dtype", [
    *((case, "float32") for case in sorted(ATTN)),
    ("cross-flash", "bfloat16"), ("self-flash", "bfloat16")])
def test_attention_matches_reference(monkeypatch, case, dtype):
    """One attention block with q/k norms (so a cross call shows it skips
    them and the rope) against the reference's; the branch the port took,
    with ``causal=False`` in every case; the flash cases in bfloat16 too."""
    hd, Sq, Skv, kind, branch = ATTN[case]
    kw = dict(head_dim=hd, qk_norm=True, dtype=dtype, param_dtype=dtype)
    rcfg = rget("seamless_m4t_large_v2", smoke=True).replace(
        use_pallas=branch == "flash_attention_bshd", **kw)
    tcfg = tget("seamless_m4t_large_v2", smoke=True).replace(**kw)
    cross = kind != "self"
    rparams = jax.device_get(rinit(jax.random.key(5),
                                   rlayers.attention_specs(rcfg, cross)))
    tparams = params_from_numpy(rparams)
    assert sorted(tparams) == sorted(tlayers.attention_specs(tcfg, cross))
    rng = np.random.default_rng(6)
    nd = _np_dtype(dtype)
    x = rng.standard_normal((B, Sq, tcfg.d_model)).astype(nd)
    mem = rng.standard_normal((B, Skv, tcfg.d_model)).astype(nd)
    kv = [rng.standard_normal((B, Skv, tcfg.kv_heads, hd)).astype(nd)
          for _ in range(2)]
    pos = np.broadcast_to(np.arange(Sq), (B, Sq))
    rargs = dict(angles=rlayers.rope_angles(jnp.asarray(pos), rcfg),
                 causal=False)
    targs = dict(angles=tlayers.rope_angles(torch.from_numpy(pos.copy()),
                                            tcfg), causal=False)
    if kind == "kv_x":
        rargs["kv_x"] = jnp.asarray(mem)
        targs["kv_x"] = params_from_numpy({"m": mem})["m"]
    if kind == "kv_precomputed":
        rargs["kv_precomputed"] = tuple(jnp.asarray(t) for t in kv)
        targs["kv_precomputed"] = tuple(params_from_numpy(
            {"k": kv[0], "v": kv[1]}).values())
    want, _ = rlayers.multihead_attention(rparams, jnp.asarray(x), rcfg,
                                          **rargs)
    taken = _watch(monkeypatch)
    got, _ = tlayers.multihead_attention(
        tparams, params_from_numpy({"x": x})["x"], tcfg, **targs)
    assert [name for name, _ in taken] == [branch]
    if branch != "gqa_attention":
        assert taken[0][1] is False
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# -- the model -------------------------------------------------------------------

CASES = {"float32": (32, SE, ST), "bfloat16": (32, SE, ST),
         "flash-float32": (64, 128, 128)}


@pytest.fixture(scope="module", params=sorted(CASES))
def encdec(request):
    dtype = request.param.removeprefix("flash-")
    hd, Se, S = CASES[request.param]
    kw = dict(head_dim=hd, dtype=dtype, param_dtype=dtype)
    rcfg = rget("seamless_m4t_large_v2", smoke=True).replace(
        use_pallas=hd == 64, **kw)
    rmodel = rbuild(rcfg)
    tmodel = tbuild(tget("seamless_m4t_large_v2", smoke=True).replace(**kw))
    rparams = jax.device_get(rinit(jax.random.key(0), rmodel.spec))
    rng = np.random.default_rng(1)
    batch = {"src": rng.standard_normal((B, Se, rcfg.d_model)).astype(
                 np.float32),
             "tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
             "targets": rng.integers(0, 256, (B, S)).astype(np.int32)}
    return (dtype, rmodel, tmodel, rparams, params_from_numpy(rparams),
            batch)


def test_forward_and_loss_match_reference(encdec, monkeypatch):
    """At head_dim 64 the encoder's layers take the flash branch
    non-causal, the decoder's self-attention causal and its
    cross-attention (128 tokens over 128 frames) non-causal."""
    dtype, rmodel, tmodel, rparams, tparams, batch = encdec
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, _ = rmodel.forward(rparams, rb)
    taken = _watch(monkeypatch)
    got, aux = tmodel.forward(tparams, tb)
    L = tmodel.cfg.enc_layers
    if tmodel.cfg.hd == 64:
        assert taken == ([("flash_attention_bshd", False)] * L
                         + [("flash_attention_bshd", True),
                            ("flash_attention_bshd", False)] * L)
    else:
        assert {name for name, _ in taken} == {"gqa_attention"}
    assert got.dtype == tmodel.cfg.adtype and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    want, _ = rmodel.loss(rparams, rb)
    got, parts = tmodel.loss(tparams, tb)
    np.testing.assert_allclose(float(got), float(want),
                               rtol=TOL[dtype]["rtol"])
    assert float(parts["ce"]) == float(got)


def test_prefill_and_three_decode_steps_match_reference(encdec):
    """Prefill into a cache of S + 3 positions (its cross K/V placeholders
    sized by ``enc_len``, replaced by the memory's), then three greedy
    decode steps fed the reference's argmax; every cache part agrees."""
    dtype, rmodel, tmodel, rparams, tparams, batch = encdec
    batch = {k: batch[k] for k in ("src", "tokens")}
    S = batch["tokens"].shape[1]
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tcache = tmodel.init_cache(B, S + 3)
    assert tcache["xk"].shape[2] == tmodel.enc_len(S + 3) == 128
    want, rcache = rmodel.prefill(rparams, rb, rmodel.init_cache(B, S + 3))
    got, tcache = tmodel.prefill(tparams, tb, tcache)
    assert tcache["xk"].shape[2] == batch["src"].shape[1]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    step = jax.jit(rmodel.decode_step)
    for i in range(3):
        tok = np.asarray(jnp.argmax(want[:, -1:], -1)).astype(np.int32)
        want, rcache = step(rparams, {"tokens": jnp.asarray(tok)}, rcache,
                            S + i)
        got, tcache = tmodel.decode_step(
            tparams, {"tokens": torch.from_numpy(tok)}, tcache, S + i)
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype],
                                   err_msg=f"decode step {i}")
    for key in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(_np(tcache[key]), _np(rcache[key]),
                                   **TOL[dtype], err_msg=key)


# -- serving -------------------------------------------------------------------

def test_generate_with_src_matches_reference():
    """Both static engines on the same prompts and frames (float32
    SMOKE): the same greedy tokens, with every generated position's top-2
    logit margin above the float32 tolerance."""
    cfg = dict(dtype="float32", param_dtype="float32")
    rmodel = rbuild(rget("seamless_m4t_large_v2", smoke=True).replace(**cfg))
    tmodel = tbuild(tget("seamless_m4t_large_v2", smoke=True).replace(**cfg))
    rparams = jax.device_get(rinit(jax.random.key(3), rmodel.spec))
    tparams = params_from_numpy(rparams)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, 256, (B, 12)).astype(np.int32)
    src = rng.standard_normal((B, SE, 128)).astype(np.float32)
    want = RServe(rmodel, rparams, max_len=24).generate(
        prompts, steps=8, extra_batch={"src": jnp.asarray(src)})
    got = ServeEngine(tmodel, tparams, max_len=24).generate(
        prompts, steps=8, extra_batch={"src": src})
    seq = np.concatenate([prompts, got[:, :-1]], axis=1)
    logits, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(seq),
                                         "src": torch.from_numpy(src)})
    top2 = logits[:, prompts.shape[1] - 1:].double().topk(2, -1).values
    assert bool((top2[..., 0] - top2[..., 1]
                 > 1e-5 + 1e-4 * top2[..., 0].abs()).all())
    np.testing.assert_array_equal(got, want)


def test_serving_without_frames_raises_by_name():
    """The serving CLI's static mode and the example make no frames."""
    argv = ["--device", "cpu", "--arch", "seamless-m4t-large-v2", "--batch",
            "1", "--steps", "2"]
    with pytest.raises(ValueError, match="'src'"):
        tserve.main(argv)
    with pytest.raises(ValueError, match="seamless-smoke.*'src'"):
        serve_batch.main(argv)
