"""PaperCNN, spatial averaging, the Hutchinson diagonal and the three
optimizers of the PyTorch port against the JAX reference, on carried
parameters and injected probes.

Tolerances: float32 matmuls and reductions are blocked and summed in a
different order by XLA and by PyTorch, so values agree to a few ulps
relative (rtol 1e-5). Gradients and Hessian-vector products are sums over
the batch and over up to 9216-wide products; where such a sum cancels, its
relative error grows, so they are held to rtol 1e-4 with an atol of 1e-5
of the tensor's largest entry (about a hundred float32 ulps at that
scale)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as ROpt
from repro.configs.base import get_config as rget
from repro.models.cnn import PaperCNN as RCNN
from repro.nn.param import init_tree as rinit
from repro.optim import adahessian as rada
from repro.optim import firstorder as rfo
from repro.optim.base import apply_updates
from repro.optim.hutchinson import hessian_diag_with_grad as rhdiag
from repro.optim.hutchinson import rademacher_like
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import get_config as tget
from repro_torch.kernels.flatten import FlatLayout
from repro_torch.models.cnn import PaperCNN as TCNN
from repro_torch.nn.param import param_count, params_from_numpy, tree_leaves
from repro_torch.optim.adahessian import spatial_average
from repro_torch.optim.base import make_optimizer
from repro_torch.optim.hutchinson import hessian_diag_with_grad


@pytest.fixture(scope="module")
def models():
    rm, tm = RCNN(rget("paper-cnn")), TCNN(tget("paper-cnn"))
    params = jax.device_get(
        jax.jit(lambda key: rinit(key, rm.spec))(jax.random.key(0)))
    return rm, tm, params


def _batch(seed, b=6):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, 28, 28, 1)).astype(np.float32),
            "labels": rng.integers(0, 10, b).astype(np.int32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _named(tree):
    return {".".join(p): np.asarray(v) for p, v in tree_leaves(tree)}


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_layout_is_the_reference_leaf_order(models):
    rm, tm, params = models
    lay = FlatLayout(tm.spec)
    assert lay.names == ("conv1.b", "conv1.w", "conv2.b", "conv2.w",
                         "fc1.b", "fc1.w", "fc2.b", "fc2.w")
    assert lay.n == param_count(tm.spec) == 1_199_882
    ref_flat = np.concatenate([np.ravel(x) for x in
                               jax.tree.leaves(params)])
    flat = lay.pack_tree(params)
    np.testing.assert_array_equal(flat.numpy(), ref_flat)
    for name, arr in _named(lay.to_numpy(flat)).items():
        np.testing.assert_array_equal(arr, _named(params)[name])
    assert [n for n, _ in tm.named_parameters()] == list(lay.names)


@pytest.mark.parametrize("seed", [1, 2])
def test_cnn_loss_accuracy_grads_match(models, seed):
    rm, tm, params = models
    batch = _batch(seed)
    (rl, raux), rg = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        params, batch)
    tp = {".".join(path): v.requires_grad_() for path, v in
          tree_leaves(params_from_numpy(params))}
    tl, taux = tm.loss(tp, _tbatch(batch))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(rl), rtol=1e-5)
    assert taux["acc"].item() == float(raux["acc"])
    assert tm.accuracy(tp, _tbatch(batch)).item() == float(
        rm.accuracy(params, batch))
    for name, want in _named(rg).items():
        _close(tp[name].grad.numpy(), want)


SHAPES = [(3, 3, 1, 32), (32,), (3, 3, 32, 64), (64,), (9216, 128), (128,),
          (128, 10), (10,), (33, 130), ()]


@pytest.mark.parametrize("shape", SHAPES)
def test_spatial_average_matches(shape):
    h = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(rada.spatial_average(jnp.asarray(h), 128))
    got = spatial_average(torch.from_numpy(h), 128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # with a leading worker axis the workers are averaged apart
    stacked = spatial_average(torch.from_numpy(np.stack([h, 2 * h])), 128,
                              batch_dims=1).numpy()
    np.testing.assert_allclose(stacked[1], 2 * want, rtol=1e-6, atol=1e-7)


def test_hutchinson_with_injected_probes_matches(models):
    rm, tm, params = models
    keys = jax.random.split(jax.random.key(11), 2)
    batches = [_batch(3), _batch(4)]
    lay = FlatLayout(tm.spec)
    ref = jax.jit(lambda p, b, key: rhdiag(
        jax.grad(lambda q: rm.loss(q, b)[0]), p, key))
    want_g, want_d = [], []
    for key, b in zip(keys, batches):
        g, d = ref(params, b, key)
        want_g.append(_named(g))
        want_d.append(_named(d))
    rademacher = jax.jit(jax.vmap(rademacher_like, in_axes=(0, None)))
    probes = lay.pack_tree(jax.device_get(rademacher(keys, params)), (2,))
    flat = lay.pack_tree(params)
    workers = torch.stack([flat, flat])
    images = torch.stack([torch.from_numpy(b["images"]) for b in batches])
    labels = torch.stack([torch.from_numpy(b["labels"]).long()
                          for b in batches])
    grads, diag, loss = hessian_diag_with_grad(
        lambda p, x, y: tm.loss(p, {"images": x, "labels": y})[0],
        lay.views(workers), [lay.views(probes)], images, labels)
    ref_loss = jax.jit(lambda p, b: rm.loss(p, b)[0])
    for i in range(2):
        np.testing.assert_allclose(
            loss[i].item(), float(ref_loss(params, batches[i])), rtol=1e-5)
        for name in lay.names:
            _close(grads[name][i].numpy(), want_g[i][name])
            _close(diag[name][i].numpy(), want_d[i][name])


@pytest.mark.parametrize("name,wd", [("sgd", 0.0), ("momentum", 0.0),
                                     ("adahessian", 0.0),
                                     ("adahessian", 1e-4), ("adam", 0.0)])
def test_optimizer_steps_match(models, name, wd):
    """Three steps of each optimizer from the same params and gradients;
    AdaHessian at the reference kernel tolerance (rtol 2e-5, atol 2e-6)."""
    rm, tm, params = models
    kw = dict(name=name, lr=0.01, momentum=0.5, weight_decay=wd)
    rcfg, tcfg = ROpt(**kw), TOpt(**kw)
    ropt = {"sgd": rfo.sgd, "momentum": rfo.momentum, "adam": rfo.adam,
            "adahessian": rada.adahessian}[name](rcfg)
    lay = FlatLayout(tm.spec)
    topt = make_optimizer(tcfg)
    rng = np.random.default_rng(5)
    rp, rstate = params, ropt.init(params)

    @jax.jit
    def ref_step(g, state, p, h):
        upd, state = ropt.update(g, state, p, {"hess_diag": h})
        return apply_updates(p, upd), state

    tp = lay.pack_tree(params)[None].clone()
    tstate = topt.init(1, lay.n, "cpu")
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), params)
        h = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), params)
        rp, rstate = ref_step(g, rstate, rp, h)
        hs = {n: spatial_average(torch.from_numpy(v), 128)
              for n, v in _named(h).items()}
        topt.step(tp, lay.pack_tree(g)[None], tstate, lay.pack(hs)[None])
    np.testing.assert_allclose(tp[0].numpy(), lay.pack_tree(rp).numpy(),
                               rtol=2e-5, atol=2e-6)
    assert int(tstate["count"][0]) == int(rstate["count"]) == 3
    for key in ("m", "v"):
        if key in rstate:
            np.testing.assert_allclose(
                tstate[key][0].numpy(), lay.pack_tree(rstate[key]).numpy(),
                rtol=2e-5, atol=2e-6)
