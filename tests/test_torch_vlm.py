"""The port's vision-language family (qwen2-vl-7b) against the JAX
reference, on the CPU.

- M-RoPE: ``VLM.positions`` and ``rope_angles`` at the full config's
  sections (16, 24, 24) and SMOKE's (6, 5, 5), for a prompt with patches,
  a text-only prompt (negative text positions: the text starts at the
  grid extent less ``num_patch_tokens``) and a decode step at the global
  index.
- ``VLM`` at SMOKE, the same weights and inputs in both packages:
  ``forward`` and ``loss`` with patches, ``prefill`` with patches and
  three decode steps at the global index (patches + text), in float32
  (rtol 1e-4 / atol 1e-5) and bfloat16 (``tests/test_torch_lm.py``'s
  ``TOL``), and once at ``head_dim=64`` with 16 patches and 112 text
  tokens, where the full-sequence calls take the flash branch (the
  reference with ``use_pallas=True``, Pallas in interpret mode; the port
  its plain version).
- ``ServeEngine.generate`` on text-only prompts, greedy tokens equal to
  the reference's (float32, with no near-tie at any generated position),
  and the port's refusal of ``patches`` in ``extra_batch``.
- One elastic round of qwen2-vl-smoke (k=2, τ=1, float32), text-only as
  the reference's session trains it, through
  ``tests/test_torch_lm_session.py``'s harness.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_vl_7b as rq
from repro.configs.base import get_config as rget
from repro.models.registry import build_model as rbuild
from repro.nn import layers as rlayers
from repro.nn.param import init_tree as rinit
from repro.nn.param import param_count as rcount
from repro.serving.engine import ServeEngine as RServe
from repro_torch.configs import qwen2_vl_7b as tq
from repro_torch.configs.base import get_config as tget
from repro_torch.models.registry import build_model as tbuild
from repro_torch.models.vlm import VLM
from repro_torch.nn import layers as tlayers
from repro_torch.nn.param import param_count, params_from_numpy, tree_leaves
from repro_torch.serving.engine import ServeEngine
from test_torch_lm import TOL, _np
from test_torch_lm_session import (_assert_state_close, _close, port_run,
                                   reference_run)
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NP, NT = 16, 112  # SMOKE's patches; text tokens: 128 inputs in all
CASES = {"float32": {}, "bfloat16": {},
         # the flash branch: Sq == Skv == 128, head_dim 64
         "flash-float32": dict(head_dim=64, mrope_sections=(12, 10, 10))}


def _cfgs(case):
    dtype = case.removeprefix("flash-")
    kw = dict(CASES[case], dtype=dtype, param_dtype=dtype)
    return (rget("qwen2_vl_7b", smoke=True).replace(
                use_pallas=case.startswith("flash"), **kw),
            tget("qwen2_vl_7b", smoke=True).replace(**kw))


@pytest.fixture(scope="module", params=sorted(CASES))
def vlm(request):
    rcfg, tcfg = _cfgs(request.param)
    rmodel, tmodel = rbuild(rcfg), tbuild(tcfg)
    rparams = jax.device_get(rinit(jax.random.key(0), rmodel.spec))
    return (request.param.removeprefix("flash-"), rmodel, tmodel, rparams,
            params_from_numpy(rparams))


def _batch(d_model, seed, n_text=NT, B=2):
    rng = np.random.default_rng(seed)
    return {"patches": rng.standard_normal((B, NP, d_model)).astype(
                np.float32),
            "tokens": rng.integers(0, 256, (B, n_text)).astype(np.int32),
            "targets": rng.integers(0, 256, (B, n_text)).astype(np.int32)}


def spec_paths(rspec, tspec):
    """(leaf path, shape, dtype name) of every leaf of the reference's and
    the port's spec trees, each in sorted-key order: (got, want)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        rspec, is_leaf=lambda x: hasattr(x, "axes"))
    want = [(tuple(k.key for k in path), s.shape, str(jnp.dtype(s.dtype)))
            for path, s in flat]
    got = [(path, s.shape, str(s.dtype).removeprefix("torch."))
           for path, s in tree_leaves(tspec)]
    return got, want


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# -- configs and M-RoPE --------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_qwen2_vl_configs_and_specs_match_reference(which):
    """Field for field, and the same spec tree (leaf paths, shapes,
    dtypes) and parameter count: 7,615,487,488 at full size."""
    got, want = getattr(tq, which), getattr(rq, which)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    rspec, tspec = rbuild(want).spec, tbuild(got).spec
    assert isinstance(tbuild(got), VLM)
    got_paths, want_paths = spec_paths(rspec, tspec)
    assert got_paths == want_paths
    assert param_count(tspec) == rcount(rspec)
    if which == "CONFIG":
        assert param_count(tspec) == 7_615_487_488


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("inputs", ["patches", "text", "decode"])
def test_mrope_positions_and_angles_match_reference(which, inputs):
    """Positions (3, B, S) equal; angles (B, S, half) at rtol 1e-4 / atol
    1e-5. ``text`` is a prompt without patches: its positions start at
    grid - num_patch_tokens (32 - 1024 at full size), below zero."""
    rcfg, tcfg = getattr(rq, which), getattr(tq, which)
    rm, tm = rbuild(rcfg), tbuild(tcfg)
    Np, g, B = rcfg.num_patch_tokens, tm.grid, 2
    S, offset, batch = {"patches": (Np + 8, 0, "patches"),
                        "text": (8, 0, None),
                        "decode": (1, Np + 8 + 3, None)}[inputs]
    rb = {"patches": np.zeros((B, Np, 1))} if batch else {}
    tb = {"patches": torch.zeros(B, Np, 1)} if batch else {}
    want = np.asarray(rm.positions(rb, B, S, offset))
    got = tm.positions(tb, B, S, offset)
    assert got.shape == (3, B, S)
    np.testing.assert_array_equal(got.numpy(), want)
    if inputs == "text":
        assert int(got.min()) == g - Np < 0
    np.testing.assert_allclose(
        tlayers.rope_angles(got, tcfg).numpy(),
        np.asarray(rlayers.rope_angles(jnp.asarray(want), rcfg)),
        rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="mrope_sections"):
        tlayers.rope_angles(got, tcfg.replace(mrope_sections=(1, 2, 3)))


# -- the model -----------------------------------------------------------------

def test_forward_and_loss_match_reference(vlm, monkeypatch):
    """Patches prepended in the activation dtype; the loss over the text
    logits only. At head_dim 64 every layer's attention takes the flash
    branch, causal."""
    dtype, rmodel, tmodel, rparams, tparams = vlm
    rb, tb = _both(_batch(tmodel.cfg.d_model, 0))
    want, _ = rmodel.forward(rparams, rb)
    flash = []
    monkeypatch.setattr(tlayers, "flash_attention_bshd", lambda *a, _f=(
        tlayers.flash_attention_bshd), **k: flash.append(k) or _f(*a, **k))
    got, aux = tmodel.forward(tparams, tb)
    assert flash == ([dict(causal=True, window=None, chunk=None)] * 2
                     if tmodel.cfg.hd == 64 else [])
    assert got.shape == (2, NP + NT, tmodel.cfg.vocab_size)
    assert got.dtype == tmodel.cfg.adtype and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    want, _ = rmodel.loss(rparams, rb)
    got, parts = tmodel.loss(tparams, tb)
    np.testing.assert_allclose(float(got), float(want),
                               rtol=TOL[dtype]["rtol"])
    assert float(parts["ce"]) == float(got)


def test_prefill_and_decode_at_the_global_index_match_reference(vlm):
    """Prefill patches + text into a cache of NP + NT + 3 positions, then
    three greedy decode steps at the global index NP + NT + i (the
    reference's decode-consistency recipe), each fed the reference's
    argmax; the caches agree too."""
    dtype, rmodel, tmodel, rparams, tparams = vlm
    batch = _batch(tmodel.cfg.d_model, 1)
    del batch["targets"]
    rb, tb = _both(batch)
    L = NP + NT + 3
    want, rcache = rmodel.prefill(rparams, rb, rmodel.init_cache(2, L))
    got, tcache = tmodel.prefill(tparams, tb, tmodel.init_cache(2, L))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    step = jax.jit(rmodel.decode_step)
    for i in range(3):
        tok = np.asarray(jnp.argmax(want[:, -1:], -1)).astype(np.int32)
        want, rcache = step(rparams, {"tokens": jnp.asarray(tok)}, rcache,
                            NP + NT + i)
        got, tcache = tmodel.decode_step(
            tparams, {"tokens": torch.from_numpy(tok)}, tcache, NP + NT + i)
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype],
                                   err_msg=f"decode step {i}")
    np.testing.assert_allclose(_np(tcache["dense"]["k"]),
                               _np(rcache["dense"]["k"]), **TOL[dtype])


# -- serving -------------------------------------------------------------------

def test_generate_text_only_matches_reference():
    """The reference's static engine and the port's on the same text-only
    prompts (float32 SMOKE): the same greedy tokens, with every generated
    position's top-2 logit margin above the float32 tolerance."""
    rcfg, tcfg = _cfgs("float32")
    rmodel, tmodel = rbuild(rcfg.replace(use_pallas=False)), tbuild(tcfg)
    rparams = jax.device_get(rinit(jax.random.key(3), rmodel.spec))
    tparams = params_from_numpy(rparams)
    prompts = np.random.default_rng(4).integers(0, 256, (2, 12)).astype(
        np.int32)
    want = RServe(rmodel, rparams, max_len=24).generate(prompts, steps=8)
    got = ServeEngine(tmodel, tparams, max_len=24).generate(prompts, steps=8)
    seq = np.concatenate([prompts, got[:, :-1]], axis=1)
    logits, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(seq)})
    top2 = logits[:, prompts.shape[1] - 1:].double().topk(2, -1).values
    assert bool((top2[..., 0] - top2[..., 1]
                 > 1e-5 + 1e-4 * top2[..., 0].abs()).all())
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="patches"):
        ServeEngine(tmodel, tparams, max_len=24).generate(
            prompts, steps=2,
            extra_batch={"patches": np.zeros((2, NP, tcfg.d_model),
                                             np.float32)})


# -- training ------------------------------------------------------------------

def test_session_round_matches_reference():
    """One round of qwen2-vl-smoke, AdaHessian with dynamic weighting,
    fused comm, k=2, τ=1, from the reference's params and probes: the
    round's record and state at the harness's rules, and ``evaluate()``."""
    case = ("qwen2-vl-7b", "adahessian", "fused", 1, 1)
    _, _, want_rec, want_state, want_eval = reference_run(*case)
    got_rec, got_state, got_eval = port_run(*case)
    assert len(got_rec) == 1
    np.testing.assert_array_equal(got_rec[0].fail, want_rec[0].fail)
    _close(got_rec[0].loss, want_rec[0].loss, "loss")
    for key in ("u", "score", "h1", "h2", "loss_w"):
        _close(getattr(got_rec[0], key), getattr(want_rec[0], key), key)
    _assert_state_close(got_state[0], want_state[0], "round 0")
    assert got_eval[1] is None and want_eval[1] is None
    np.testing.assert_allclose(got_eval[0], want_eval[0], rtol=1e-4)
