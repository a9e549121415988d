"""The port's three kernels: each plain PyTorch version against the JAX
Pallas kernel it replaces (jit, ``interpret=True``, as
tests/test_local_fused.py runs it).

Tolerances are the reference's own: AdaHessian step rtol 2e-5, atol 2e-6
(tests/test_kernels.py); batched elastic exchange rtol 1e-5, atol 1e-6
(tests/test_comm_fused.py); one-worker exchange 1e-6 in float32
(tests/test_kernels.py). The CUDA kernels themselves are held to these
plain versions on the card by tests/test_torch_kernels_cuda.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as ROpt
from repro.kernels.adahessian.ops import adahessian_update_batched as rada
from repro.kernels.elastic.ops import (elastic_update_batched_pallas,
                                       elastic_update_pallas)
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.kernels import kernels
from repro_torch.kernels.adahessian import ops as tada
from repro_torch.kernels.elastic import ops as tela
from repro_torch.kernels.flatten import FlatLayout
from repro_torch.nn.param import ParamSpec
from repro_torch.optim.adahessian import bias_corrections

# bias, conv kernel, d % 128 != 0: n = 4387, not a multiple of 128
SHAPES = {"p0": (7,), "p1": (3, 3, 2, 5), "p2": (33, 130)}
LAYOUT = FlatLayout({k: ParamSpec(s) for k, s in SHAPES.items()})


def _tree(rng, lead, scale=1.0):
    return {k: (scale * rng.standard_normal(lead + s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(tree, lead=()):
    return LAYOUT.pack_tree(tree, lead)


def _problem(k, seed=0):
    rng = np.random.default_rng(seed)
    p, g, h = _tree(rng, (k,)), _tree(rng, (k,)), _tree(rng, (k,))
    m = _tree(rng, (k,), 0.1)
    v = {n: np.abs(x) for n, x in _tree(rng, (k,), 0.1).items()}
    count = (np.arange(1, k + 1, dtype=np.int32) * 2 + 1)  # distinct t
    return p, g, h, m, v, count


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("wd,power", [(0.0, 1.0), (1e-4, 1.0), (0.0, 0.5)])
def test_adahessian_plain_matches_pallas(k, wd, power):
    kw = dict(name="adahessian", lr=1e-3, weight_decay=wd,
              hessian_power=power)
    p, g, h, m, v, count = _problem(k)
    fk = jax.jit(functools.partial(rada, cfg=ROpt(**kw), use_kernel=True,
                                   interpret=True))
    new_p, new_s = fk(p, g, h, {"count": jnp.asarray(count), "m": m, "v": v})
    cfg = TOpt(**kw)
    tp, tm_, tv = _flat(p, (k,)), _flat(m, (k,)), _flat(v, (k,))
    before = kernels()["adahessian_update_batched"].launches
    tada.adahessian_update_batched(
        tp, _flat(g, (k,)), _flat(h, (k,)), tm_, tv,
        bias_corrections(torch.from_numpy(count + 1), cfg.betas),
        lr=cfg.lr, b1=cfg.betas[0], b2=cfg.betas[1],
        denom_pow=cfg.hessian_power / 2.0, eps=cfg.eps,
        lrwd=cfg.lr * cfg.weight_decay)
    # a CPU tensor takes the plain version: no launch is counted
    assert kernels()["adahessian_update_batched"].launches == before
    for got, want in ((tp, new_p), (tm_, new_s["m"]), (tv, new_s["v"])):
        np.testing.assert_allclose(got.numpy(), _flat(want, (k,)).numpy(),
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("stale", [False, True])
def test_elastic_batched_plain_matches_pallas(k, stale):
    rng = np.random.default_rng(k)
    ws, mtree, rtree = _tree(rng, (k,)), _tree(rng, ()), _tree(rng, ())
    h1 = rng.uniform(0, 1, k).astype(np.float32)
    h2 = rng.uniform(0, 0.3, k).astype(np.float32)
    f = jax.jit(functools.partial(elastic_update_batched_pallas,
                                  interpret=True))
    want_w, want_m = f(ws, mtree, h1, h2,
                       master_ref=rtree if stale else None)
    tw, tm_ = _flat(ws, (k,)), _flat(mtree)
    before = kernels()["elastic_update_batched"].launches
    tela.elastic_update_batched(tw, tm_, torch.from_numpy(np.stack([h1, h2])),
                                _flat(rtree) if stale else None)
    assert kernels()["elastic_update_batched"].launches == before
    np.testing.assert_allclose(tw.numpy(), _flat(want_w, (k,)).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm_.numpy(), _flat(want_m).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h1,h2", [(0.25, 0.07), (1.0, 0.0), (0.0, 0.0)])
def test_elastic_one_worker_plain_matches_pallas(h1, h2):
    rng = np.random.default_rng(1)
    w, m = _tree(rng, ()), _tree(rng, ())
    want_w, want_m = elastic_update_pallas(w, m, h1, h2, interpret=True)
    tw, tm_ = _flat(w), _flat(m)
    before = kernels()["elastic_update"].launches
    tela.elastic_update(tw, tm_, torch.tensor([[h1], [h2]]))
    assert kernels()["elastic_update"].launches == before
    np.testing.assert_allclose(tw.numpy(), _flat(want_w).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm_.numpy(), _flat(want_m).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(2, 5)
    with pytest.raises(TypeError):
        tela.elastic_update_batched(x.double(), torch.zeros(5),
                                    torch.zeros(2, 2))
    with pytest.raises(ValueError):
        tela.elastic_update_batched(x, torch.zeros(4), torch.zeros(2, 2))
    with pytest.raises(ValueError):
        tela.elastic_update(x[0], torch.zeros(5), torch.zeros(2, 2))
    with pytest.raises(ValueError):
        tela.elastic_update(torch.zeros(5, 2)[:, 0], torch.zeros(5),
                            torch.zeros(2, 1))  # not contiguous
    with pytest.raises(ValueError):
        tada.adahessian_update_batched(x, x, x, x, x, torch.zeros(2, 3),
                                       lr=0.1, b1=0.9, b2=0.99,
                                       denom_pow=0.5, eps=1e-8)
