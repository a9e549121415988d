"""Gradients through the port's attention, against the reference's
training path, on the CPU.

The flash kernel has no backward (nor has the reference's Pallas kernel;
reference training runs without ``use_pallas``). So ``multihead_attention``
takes the flash branch only when nothing tracks q/k/v, and under autograd
or a ``torch.func`` transform it takes the reference's non-Pallas
branch: ``gqa_attention``, or ``blockwise_attention`` at ``Sq >= 1024``.
Held here:

- at a flash shape (qwen3-4b SMOKE with head_dim 64, 128 tokens, float32)
  the gradient of every attention leaf (``wq``/``wk``/``wv``/``wo`` and
  the qk-norm scales) under ``torch.func.grad`` and under ``backward()``
  equals ``jax.grad`` of the reference's ``multihead_attention`` at rtol
  1e-4 / atol 1e-5 (float32 summation order), and the flash wrapper is
  never called while it is tracked — but is under ``no_grad``;
- at 1024 tokens (tiny heads) a tracked call takes ``blockwise_attention``,
  whose gradient equals the reference's blockwise gradient at 2e-4 (the
  reference's own bound, ``tests/test_flash_blockwise.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as rget
from repro.nn import flash as rflash
from repro.nn import layers as rlayers
from repro.nn.param import init_tree as rinit
from repro_torch.configs.base import get_config as tget
from repro_torch.nn import flash as tflash
from repro_torch.nn import layers as tlayers
from repro_torch.nn.param import params_from_numpy, tree_leaves
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@functools.lru_cache(maxsize=None)
def _setup(S, B, seed):
    """Configs, the reference's attention params, inputs (B, S, d), the
    loss weights, positions, and ``jax.grad`` of the reference's
    ``multihead_attention`` (``use_pallas`` off: its training path), once
    per module for each shape."""
    kw = dict(head_dim=64, dtype="float32", param_dtype="float32")
    rcfg = rget("qwen3_4b", smoke=True).replace(**kw)
    tcfg = tget("qwen3_4b", smoke=True).replace(**kw)
    rparams = jax.device_get(jax.jit(lambda key: rinit(
        key, rlayers.attention_specs(rcfg)))(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    ang = rlayers.rope_angles(jnp.asarray(pos), rcfg)

    def loss(p):
        out = rlayers.multihead_attention(p, jnp.asarray(x), rcfg,
                                          angles=ang)[0]
        return (out * w).sum()

    want = jax.device_get(jax.jit(jax.grad(loss))(rparams))
    return rcfg, tcfg, rparams, x, w, pos, want


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **kw):
        calls.append(tlayers.tracked(*a[:3]))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def _assert_grads(got, want, **tol):
    got = dict(tree_leaves(got))
    for path, leaf in tree_leaves(want):
        np.testing.assert_allclose(got[path].detach().numpy(), leaf,
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize("how", ["torch.func", "backward"])
def test_flash_shaped_attention_gradients_match_reference(monkeypatch, how):
    _, tcfg, rparams, x, w, pos, want = _setup(128, 2, 0)
    flash = _count(monkeypatch, tlayers, "flash_attention_bshd")
    gqa = _count(monkeypatch, tlayers, "gqa_attention")
    ang = tlayers.rope_angles(torch.from_numpy(pos.copy()), tcfg)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)

    def loss(p):
        return (tlayers.multihead_attention(p, xt, tcfg,
                                            angles=ang)[0] * wt).sum()

    params = params_from_numpy(rparams)
    if how == "torch.func":
        got = torch.func.grad(loss)(params)
    else:
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_()
        loss(params).backward()
        got = {path: leaf.grad for path, leaf in tree_leaves(params)}
        got = {name: got[(name,)] for (name,) in got}
    assert flash == [] and gqa == [True]
    assert {"wq", "wk", "wv"} <= set(got)
    _assert_grads(got, want, rtol=1e-4, atol=1e-5)
    with torch.no_grad():  # untracked: the flash branch, as in serving
        loss(params_from_numpy(rparams))
    assert flash == [False] and gqa == [True]


def test_long_tracked_call_takes_blockwise_with_reference_gradients(
        monkeypatch):
    """1024 tokens at a flash shape: under ``torch.func.grad`` the call
    takes ``blockwise_attention`` (the flash kernel's shape rule no longer
    applies), not the flash wrapper."""
    _, tcfg, rparams, x, w, pos, want = _setup(1024, 1, 1)
    flash = _count(monkeypatch, tlayers, "flash_attention_bshd")
    blockwise = _count(monkeypatch, tlayers, "blockwise_attention")
    ang = tlayers.rope_angles(torch.from_numpy(pos.copy()), tcfg)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = torch.func.grad(lambda p: (tlayers.multihead_attention(
        p, xt, tcfg, angles=ang)[0] * wt).sum())(params_from_numpy(rparams))
    assert flash == [] and blockwise == [True]
    _assert_grads(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mask", [dict(causal=True), dict(causal=True,
                                                          window=700)])
def test_blockwise_gradients_match_reference(mask):
    """``blockwise_attention`` alone at Sq = 1024 (two 512-blocks, tiny
    heads) under ``torch.func``'s ``vmap(grad)`` — the trainer's
    transform — against ``jax.grad`` of the reference's blockwise
    attention, for q, k and v."""
    rng = np.random.default_rng(2)
    B, S, H, KVH, D = 1, 1024, 2, 1, 8
    q = rng.standard_normal((2, B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, B, S, KVH, D)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S), (B, S))

    def rloss(q, k, v):
        return (rflash.blockwise_attention(
            q, k, v, q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
            **mask) ** 2).sum()

    want = jax.device_get(jax.jit(jax.vmap(jax.grad(
        rloss, argnums=(0, 1, 2))))(q, k, v))
    tpos = torch.from_numpy(pos.copy())

    def tloss(q, k, v):
        return (tflash.blockwise_attention(q, k, v, q_pos=tpos, kv_pos=tpos,
                                           **mask) ** 2).sum()

    got = torch.func.vmap(torch.func.grad(tloss, argnums=(0, 1, 2)))(
        *map(torch.from_numpy, (q, k, v)))
    for name, g, ref in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=2e-4,
                                   err_msg=name)
