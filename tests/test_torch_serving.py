"""The port's serving path on the CPU.

- ``traffic`` and ``scheduler`` are numpy copies: the same traces, and the
  same ``RequestResult``s from the same engine on the same (fake) clock.
- The slice as a whole: the port's ``ContinuousEngine`` and the
  reference's, driven by one ``Scheduler`` trace from ``synthetic_traffic``
  in float32 with every admit on the flash branch (qwen3-4b SMOKE with
  ``head_dim=64``, ``prefill_len=128``; the reference with
  ``use_pallas=True``), generate the same tokens for every request. A
  near-tie would make that comparison meaningless, so the test first
  asserts that the top-2 logit margin at every generated position exceeds
  the float32 logit tolerance (rtol 1e-4, atol 1e-5).
- The port's own bitwise property: on the degenerate all-at-t0 batch its
  ``ContinuousEngine`` equals its ``ServeEngine`` token for token.
- The slot lifecycle, validation, and ``launch/serve.py`` on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

import repro.serving.scheduler as rsched
import repro.serving.traffic as rtraffic
import repro_torch.serving.scheduler as tsched
import repro_torch.serving.traffic as ttraffic
from repro.configs.base import get_config as rget
from repro.models.registry import build_model as rbuild
from repro.nn.param import init_tree as rinit
from repro.serving.continuous import ContinuousEngine as RContinuous
from repro_torch.configs.base import get_config as tget
from repro_torch.kernels import kernels
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import build_model as tbuild
from repro_torch.nn import layers as tlayers
from repro_torch.nn.param import init_tree, params_from_numpy
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import ServeEngine

PREFILL = 128


class FakeClock:
    """``time.perf_counter`` that advances 10 ms per read: a scheduler's
    virtual clock then replays identically whatever the machine's speed."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t


def _results(results):
    return [(r.rid, r.tokens.tolist(), r.reason, r.arrival, r.admitted_at,
             r.finished_at) for r in results]


# -- numpy copies ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(num_requests=40, prompt_lens=(3, 9), max_new=5, seed=3),
    dict(num_requests=7, rate=50.0, burst_factor=1.0, deadline=0.2,
         eos_id=4, vocab_size=11, seed=12)])
def test_traffic_copy_identical(kw):
    want = rtraffic.synthetic_traffic(rtraffic.TrafficConfig(**kw))
    got = ttraffic.synthetic_traffic(ttraffic.TrafficConfig(**kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.max_new, g.arrival, g.deadline, g.eos_id) == (
            w.rid, w.max_new, w.arrival, w.deadline, w.eos_id)
        assert g.prompt.dtype == w.prompt.dtype
        np.testing.assert_array_equal(g.prompt, w.prompt)


class FakeEngine:
    """A deterministic engine with the ``ContinuousEngine`` surface: slot
    ``s`` emits ``(rid * 7 + step) % 11``; ``eos_id`` ends a request."""

    def __init__(self, capacity):
        self.capacity, self.ticks = capacity, 0
        self._live, self._done = {}, []

    @property
    def num_active(self):
        return len(self._live)

    def vacant_slots(self):
        return [s for s in range(self.capacity) if s not in self._live]

    def active_slots(self):
        return sorted(self._live)

    def admit(self, prompt, *, max_new, eos_id=None, rid=None):
        slot = self.vacant_slots()[0]
        self._live[slot] = [rid, max_new, eos_id, []]
        self._emit(slot)
        return slot

    def _emit(self, slot):
        rid, max_new, eos, toks = self._live[slot]
        toks.append((rid * 7 + len(toks)) % 11)
        if toks[-1] == eos:
            self._finish(slot, "eos")
        elif len(toks) >= max_new:
            self._finish(slot, "length")

    def _finish(self, slot, reason):
        rid, _, _, toks = self._live.pop(slot)
        self._done.append(type("F", (), dict(
            rid=rid, slot=slot, reason=reason,
            tokens=np.asarray(toks, np.int32)))())

    def evict(self, slot):
        self._finish(slot, "evicted")

    def drain_finished(self):
        done, self._done = self._done, []
        return done

    def step(self):
        if self._live:
            self.ticks += 1
            for slot in sorted(self._live):
                self._emit(slot)
        return self.drain_finished()


@pytest.mark.parametrize("kw,sched_kw,reasons", [
    (dict(num_requests=20, max_new=6, vocab_size=50, seed=1), {},
     {"length"}),
    (dict(num_requests=30, max_new=9, vocab_size=50, rate=80.0,
          deadline=0.15, eos_id=3, seed=2),
     dict(max_queue=4, max_admissions_per_tick=1),
     {"eos", "evicted", "rejected"}),
])
def test_scheduler_copy_identical_on_fake_engine(monkeypatch, kw, sched_kw,
                                                  reasons):
    out = []
    for sched_mod, traffic_mod in ((rsched, rtraffic), (tsched, ttraffic)):
        monkeypatch.setattr(sched_mod, "time", FakeClock())
        trace = traffic_mod.synthetic_traffic(traffic_mod.TrafficConfig(**kw))
        sched = sched_mod.Scheduler(FakeEngine(3), **sched_kw)
        out.append((_results(sched.run(trace)), sched.rejected, sched.vnow))
    assert out[1] == out[0]
    assert {r[2] for r in out[0][0]} == reasons


# -- the slice as a whole --------------------------------------------------------

@pytest.fixture(scope="module")
def flash_lm():
    """qwen3-4b SMOKE at head_dim 64 in float32: both packages' models and
    the reference's params carried into the port."""
    kw = dict(head_dim=64, dtype="float32", param_dtype="float32")
    rmodel = rbuild(rget("qwen3_4b", smoke=True).replace(use_pallas=True,
                                                         **kw))
    tmodel = tbuild(tget("qwen3_4b", smoke=True).replace(**kw))
    rparams = jax.device_get(rinit(jax.random.key(0), rmodel.spec))
    return rmodel, tmodel, rparams, params_from_numpy(rparams)


def _serve_trace(monkeypatch, sched_mod, engine, trace):
    monkeypatch.setattr(sched_mod, "time", FakeClock())
    sched = sched_mod.Scheduler(engine)
    return {r.rid: r for r in sched.run(trace)}, sched


def test_continuous_engine_matches_reference_through_scheduler(
        monkeypatch, flash_lm):
    rmodel, tmodel, rparams, tparams = flash_lm
    tcfg = dict(num_requests=5, prompt_lens=(16, 77, PREFILL), max_new=8,
                vocab_size=256, rate=40.0, seed=0)
    eng_kw = dict(capacity=2, max_len=PREFILL + 8 + 1, prefill_len=PREFILL)
    want, _ = _serve_trace(
        monkeypatch, rsched, RContinuous(rmodel, rparams, **eng_kw),
        rtraffic.synthetic_traffic(rtraffic.TrafficConfig(**tcfg)))
    flash = kernels()["flash_attention_fwd"]
    before, calls = flash.launches, []
    monkeypatch.setattr(tlayers, "flash_attention_bshd",
                        lambda *a, **k: calls.append(1) or
                        tflash.flash_attention_bshd(*a, **k))
    trace = ttraffic.synthetic_traffic(ttraffic.TrafficConfig(**tcfg))
    got, sched = _serve_trace(monkeypatch, tsched,
                              ContinuousEngine(tmodel, tparams, **eng_kw),
                              trace)
    # every admit's layers took the flash branch, in its plain version
    assert len(calls) == 5 * tmodel.cfg.num_layers
    assert flash.launches == before
    assert sorted(got) == sorted(want) == list(range(5))
    # precondition: no near-tie at any generated position
    for req in trace:
        gen = got[req.rid].tokens
        seq = np.concatenate([req.prompt, gen[:-1]])[None]
        logits, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(seq)})
        rows = logits[0, len(req.prompt) - 1:].double()
        top2 = rows.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        tol = 1e-5 + 1e-4 * top2[:, 0].abs()
        assert bool((margin > tol).all()), (req.rid, margin.min().item())
        assert rows.argmax(-1).tolist() == gen.tolist()
    for rid in want:
        assert got[rid].reason == want[rid].reason == "length"
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens,
                                      err_msg=f"request {rid}")


def _prompts(n, length, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype("int32")


@pytest.fixture(scope="module")
def smoke():
    model = tbuild(tget("qwen3_4b", smoke=True))
    return model, init_tree(torch.Generator().manual_seed(0), model.spec)


def test_degenerate_static_batch_identical(smoke):
    """All requests at t=0, identical lengths: the port's continuous engine
    reproduces the port's ``ServeEngine`` token for token."""
    model, params = smoke
    prompts = _prompts(3, 8, model.cfg.vocab_size)
    want = ServeEngine(model, params, max_len=64).generate(prompts, steps=10)
    eng = ContinuousEngine(model, params, capacity=3, max_len=64,
                           prefill_len=8)
    for i in range(3):
        eng.admit(prompts[i], max_new=10, rid=i)
    done = []
    while eng.num_active:
        done += eng.step()
    got = np.stack([f.tokens for f in sorted(done, key=lambda f: f.rid)])
    np.testing.assert_array_equal(got, want)
    assert all(f.reason == "length" for f in done)


def test_midflight_join_matches_solo_run(smoke):
    model, params = smoke
    prompts = _prompts(2, 8, model.cfg.vocab_size, seed=1)
    late = _prompts(1, 5, model.cfg.vocab_size, seed=2)
    eng = ContinuousEngine(model, params, capacity=3, max_len=64,
                           prefill_len=8)
    eng.admit(prompts[0], max_new=30, rid=0)
    eng.admit(prompts[1], max_new=30, rid=1)
    for _ in range(5):
        eng.step()
    eng.admit(late[0], max_new=8, rid=2)
    done = []
    while 2 not in {f.rid for f in done}:
        done += eng.step()
    got = next(f for f in done if f.rid == 2).tokens
    solo = ServeEngine(model, params, max_len=64).generate(late, steps=8)
    np.testing.assert_array_equal(got, solo[0])


def test_eos_evict_swap_and_slot_reuse(smoke):
    model, params = smoke
    p = _prompts(1, 8, model.cfg.vocab_size)[0]
    eng = ContinuousEngine(model, params, capacity=1, max_len=32,
                           prefill_len=8)
    eng.admit(p, max_new=8, rid=0)
    done = []
    while eng.num_active:
        done += eng.step()
    first = done[0].tokens.tolist()
    # the first generated position whose token has not appeared before
    j = next(i for i, t in enumerate(first) if i and t not in first[:i])
    eos = first[j]
    eng2 = ContinuousEngine(model, params, capacity=1, max_len=32,
                            prefill_len=8, eos_id=eos)
    slot = eng2.admit(p, max_new=10, rid=0)
    done = []
    while not done:
        done = eng2.step()
    assert done[0].reason == "eos"
    assert done[0].tokens.tolist() == first[:j + 1]
    assert eng2.num_active == 0
    slot2 = eng2.admit(_prompts(1, 4, model.cfg.vocab_size, 9)[0],
                       max_new=3, rid=1, eos_id=-1)
    assert slot2 == slot
    eng2.swap_params({k: v for k, v in params.items()})
    assert eng2.swaps == 1
    eng2.evict(slot2)
    (f,) = eng2.drain_finished()
    assert f.reason == "evicted" and f.tokens.size == 1
    # max_new=1 finishes inside admit: the first token is the prefill's
    eng2.admit(p, max_new=1, rid=7, eos_id=-1)
    (f,) = eng2.drain_finished()
    assert f.rid == 7 and f.reason == "length" and f.tokens.size == 1


def test_validation_errors(smoke):
    model, params = smoke
    with pytest.raises(ValueError, match="capacity"):
        ContinuousEngine(model, params, capacity=0)
    with pytest.raises(ValueError, match="prefill_len"):
        ContinuousEngine(model, params, max_len=8, prefill_len=16)
    eng = ContinuousEngine(model, params, capacity=1, max_len=16,
                           prefill_len=8)
    p = _prompts(1, 8, model.cfg.vocab_size)[0]
    with pytest.raises(ValueError, match="prompt length"):
        eng.admit(np.zeros(9, np.int32), max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        eng.admit(p, max_new=0)
    with pytest.raises(ValueError, match="overruns"):
        eng.admit(p, max_new=9)
    eng.admit(p, max_new=2)
    with pytest.raises(RuntimeError, match="pool full"):
        eng.admit(p, max_new=2)
    eng.evict(0)
    with pytest.raises(ValueError, match="not live"):
        eng.evict(0)
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params({"embed": params["embed"]})
    with pytest.raises(ValueError, match="overruns"):
        ServeEngine(model, params, max_len=16).generate(
            _prompts(2, 8, 256), steps=9)
    with pytest.raises(NotImplementedError, match="family"):
        ContinuousEngine(type("M", (), {"cfg": tget("paper-cnn")})(), params)


def test_serve_cli_on_the_cpu(capsys):
    tserve.main(["--device", "cpu", "--traffic", "3", "--steps", "4",
                 "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "served 3/3 requests, 12 tokens" in out
    tserve.main(["--device", "cpu", "--batch", "2", "--steps", "3",
                 "--prompt-len", "8", "--eos-id", "5"])
    assert "trial 1:" in capsys.readouterr().out
    for flag in ("--restore", "--watch"):
        with pytest.raises(NotImplementedError, match="checkpoint"):
            tserve.main(["--device", "cpu", flag, "/nonexistent"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main([])
