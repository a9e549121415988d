"""The port's blockwise attention (``repro_torch.nn.flash``) against the
JAX reference's, on the CPU.

- ``blockwise_attention`` against the reference's, and against both
  packages' ``naive_attention``, over the mask cases and the
  decode-positions case of ``tests/test_flash_blockwise.py`` (blocks of
  16-256), from shared numpy inputs, at its tolerance (rtol = atol =
  3e-5); rows with no visible key give zeros; the host's block-skip rule
  counts the live block pairs; gradients agree with the naive oracle's;
- one ``multihead_attention`` call at Sq = 1024 per new configuration
  (SMOKE, float32): both packages take the blockwise branch and agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.flash as rflash
from repro.configs.base import get_config as rget
from repro.models.registry import build_model as rbuild
from repro.nn import layers as rlayers
from repro.nn.param import init_tree as rinit
from repro_torch.configs.base import get_config as tget
from repro_torch.nn import flash as tflash
from repro_torch.nn import layers as tlayers
from repro_torch.nn.param import params_from_numpy
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=3e-5, atol=3e-5)
MASKS = [dict(causal=True), dict(causal=False),
         dict(causal=True, window=40), dict(causal=True, chunk=32),
         dict(causal=True, window=7, chunk=16)]


def _inputs(seed, B, Sq, Skv, H, KVH, D, q_shift=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D))]
    qp = np.broadcast_to(np.arange(Sq) + q_shift, (B, Sq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(Skv), (B, Skv)).astype(np.int32)
    return arrays + [qp, kp]


def _both(q, k, v, qp, kp):
    r = dict(zip("qkv", map(jnp.asarray, (q, k, v))),
             q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp))
    t = dict(zip("qkv", (torch.from_numpy(a) for a in (q, k, v))),
             q_pos=torch.from_numpy(qp.copy()),
             kv_pos=torch.from_numpy(kp.copy()))
    return r, t


def _agree(case, blocks, kw):
    r, t = _both(*case)
    got = tflash.blockwise_attention(**t, **blocks, **kw).numpy()
    for want in (rflash.blockwise_attention(**r, **blocks, **kw),
                 rflash.naive_attention(**r, **kw),
                 tflash.naive_attention(**t, **kw).numpy()):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    return got


@pytest.mark.parametrize("kw", MASKS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_blockwise_matches_reference(kw):
    _agree(_inputs(0, 2, 128, 128, 4, 2, 32), dict(block_q=32, block_k=32),
           kw)


def test_blockwise_decode_positions():
    """Queries shifted 7 positions past their keys, blocks of 256 x 128."""
    _agree(_inputs(1, 2, 512, 512, 4, 4, 16, q_shift=7),
           dict(block_q=256, block_k=128), dict(causal=True))


def test_blockwise_masked_rows_zero():
    """Rows whose window lies wholly past every key give zeros: every
    block pair is skipped and the ``l == 0`` guard divides by one."""
    case = _inputs(3, 1, 32, 32, 1, 1, 8, q_shift=1000)
    kw = dict(causal=True, window=10)
    got = _agree(case, dict(block_q=16, block_k=16), kw)
    np.testing.assert_array_equal(got, 0.0)
    t = _both(*case)[1]
    assert tflash.live_blocks(t["q_pos"], t["kv_pos"], 16, 16,
                              chunk=None, **kw) == [[], []]


@pytest.mark.parametrize("S,block,kw,want", [
    (8192, 512, dict(causal=True, window=4096), 108),  # h2o-danube-1.8b
    (2048, 512, dict(causal=True, window=None), 10),   # stablelm-3b
    (1024, 128, dict(causal=True, window=None), 36),
    (128, 32, dict(causal=False, window=None), 16),
])
def test_live_block_pairs(S, block, kw, want):
    pos = torch.arange(S)[None]
    live = tflash.live_blocks(pos, pos, block, block, chunk=None, **kw)
    assert sum(map(len, live)) == want


def test_blockwise_gradients_match_naive():
    q, k, v, qp, kp = _inputs(2, 1, 64, 64, 2, 2, 16)
    r, t = _both(q, k, v, qp, kp)
    tq = t.pop("q").requires_grad_()
    tflash.blockwise_attention(tq, **t, block_q=16, block_k=16,
                               window=24).sum().backward()
    got = tq.grad.numpy()
    oracle = torch.from_numpy(q).requires_grad_()
    tflash.naive_attention(oracle, **t, window=24).sum().backward()
    rq = r.pop("q")
    want = jax.grad(lambda x: rflash.blockwise_attention(
        x, **r, block_q=16, block_k=16, window=24).sum())(rq)
    for ref in (oracle.grad.numpy(), np.asarray(want)):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["stablelm_3b", "h2o_danube_1_8b"])
def test_multihead_attention_takes_blockwise(arch, monkeypatch):
    """A 1024-token full-sequence call: outside the flash branch (head_dim
    32; stablelm's partial rotary), ``Sq >= 1024`` and both lengths
    multiples of 512, so each package runs its blockwise attention once
    (danube-smoke's window of 32 inside it)."""
    kw = dict(dtype="float32", param_dtype="float32")
    rcfg = rget(arch, smoke=True).replace(**kw)
    tcfg = tget(arch, smoke=True).replace(**kw)
    rparams = jax.device_get(rinit(jax.random.key(0), rbuild(rcfg).spec))
    ratt = jax.tree.map(lambda a: a[0], rparams["dense_layers"]["attn"])
    tatt = params_from_numpy(ratt)
    taken = []
    for mod, tag in ((rflash, "reference"), (tlayers, "port")):
        fn = mod.blockwise_attention
        monkeypatch.setattr(mod, "blockwise_attention",
                            lambda *a, _f=fn, _t=tag, **k:
                            taken.append(_t) or _f(*a, **k))
    S = 1024
    x = np.random.default_rng(5).standard_normal(
        (1, S, rcfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None].astype(np.int32)
    want, _ = rlayers.multihead_attention(
        ratt, jnp.asarray(x), rcfg,
        angles=rlayers.rope_angles(jnp.asarray(pos), rcfg))
    got, _ = tlayers.multihead_attention(
        tatt, torch.from_numpy(x), tcfg,
        angles=tlayers.rope_angles(torch.from_numpy(pos), tcfg))
    assert taken == ["reference", "port"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
