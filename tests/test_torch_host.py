"""Host-side parity of the PyTorch port with the JAX reference: the threefry
failure schedule, every scenario and membership stream, traces, data, and
the config dataclasses. All of it is numpy in the port, so the bar is
bit-identity."""
import dataclasses

import numpy as np
import pytest

import repro.configs.base as rcfg
import repro.core.failure as rfail
import repro.core.scenarios as rscen
import repro.data.pipeline as rpipe
import repro.data.synthetic as rsyn
import repro_torch.configs.base as tcfg
import repro_torch.core.failure as tfail
import repro_torch.core.scenarios as tscen
import repro_torch.data.pipeline as tpipe
import repro_torch.data.synthetic as tsyn


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, 2**32 + 5,
                                  2**40 + 3])
@pytest.mark.parametrize("shape,prob", [((30, 4), 1 / 3), ((17, 8), 0.5),
                                        ((1, 1), 0.9), ((64, 3), 0.05)])
def test_threefry_iid_schedule_bit_exact(seed, shape, prob):
    want = rfail.failure_schedule_np(seed, *shape, prob)
    got = tfail.failure_schedule_np(seed, *shape, prob)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


def _sched_arrays(s):
    return {f: getattr(s, f) for f in ("fail", "straggle", "restart",
                                       "active", "corrupt", "speed")}


@pytest.mark.parametrize("name", tcfg.FAILURE_SCENARIOS)
@pytest.mark.parametrize("seed", [0, 7, 2**33 + 1])
def test_every_failure_scenario_identical(name, seed):
    kw = dict(num_workers=6, failure_scenario=name)
    rs = rscen.make_scenario(rcfg.ElasticConfig(**kw)).schedule(seed, 25, 6)
    ts = tscen.make_scenario(tcfg.ElasticConfig(**kw)).schedule(seed, 25, 6)
    for field, want in _sched_arrays(rs).items():
        got = getattr(ts, field)
        if want is None:
            assert got is None, field
        else:
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=field)
    np.testing.assert_array_equal(ts.failed_recent_all(),
                                  rs.failed_recent_all())
    for r in (0, 1, 24):
        np.testing.assert_array_equal(ts.failed_recent(r),
                                      rs.failed_recent(r))


@pytest.mark.parametrize("kw", [
    dict(membership_scenario="static", capacity=8),
    dict(membership_scenario="scale_up", capacity=8),
    dict(membership_scenario="scale_down"),
    dict(membership_scenario="preempt_rejoin", membership_k=2),
    dict(membership_scenario="plan", capacity=8,
         membership_plan=((2, 2), (5, 7))),
])
def test_membership_streams_and_traces_identical(kw):
    rm = rscen.make_membership(rcfg.ElasticConfig(num_workers=4, **kw))
    tm = tscen.make_membership(tcfg.ElasticConfig(num_workers=4, **kw))
    cap = kw.get("capacity", 4)
    want = rm.active_schedule(10, cap, 4)
    np.testing.assert_array_equal(tm.active_schedule(10, cap, 4), want)
    # a trace written by one package reads back identically in the other
    rs = rscen.make_scenario(rcfg.ElasticConfig(
        num_workers=4, capacity=cap if cap > 4 else 0,
        failure_scenario="crash_restart")).schedule(3, 10, cap)
    rs = rs.with_membership(want)
    lines = rscen.trace_lines(rs)
    assert tscen.trace_lines(tscen.parse_trace(lines)) == lines
    back = tscen.parse_trace(lines)
    for field, arr in _sched_arrays(rs).items():
        if arr is not None:
            np.testing.assert_array_equal(getattr(back, field), arr)


def test_synthetic_images_and_batches_byte_identical():
    rds = rsyn.SyntheticImages(n=300, n_test=40, seed=3)
    tds = tsyn.SyntheticImages(n=300, n_test=40, seed=3)
    for f in ("templates", "images", "labels", "test_images", "test_labels"):
        a, b = getattr(rds, f), getattr(tds, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for k, tau, ratio in ((4, 2, 0.25), (3, 1, 0.0), (8, 3, 0.125)):
        kw = dict(num_workers=k, tau=tau, overlap_ratio=ratio)
        rb = rpipe.WorkerBatcher(rds.images, rds.labels,
                                 rcfg.ElasticConfig(**kw), batch_size=16,
                                 seed=5)
        tb = tpipe.WorkerBatcher(tds.images, tds.labels,
                                 tcfg.ElasticConfig(**kw), batch_size=16,
                                 seed=5)
        for _ in range(6):  # enough rounds to wrap and reshuffle
            want, got = rb.round_batches(), tb.round_batches()
            assert sorted(want) == sorted(got)
            for key in want:
                assert got[key].dtype == want[key].dtype
                assert got[key].tobytes() == want[key].tobytes()


def _fields(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory())
            if (f.default is not dataclasses.MISSING
                or f.default_factory is not dataclasses.MISSING)
            else dataclasses.MISSING for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["ElasticConfig", "OptimizerConfig"])
def test_config_fields_and_defaults_match(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(rcfg, name))


def test_model_config_fields_are_a_matching_subset():
    ref = _fields(rcfg.ModelConfig)
    for field, default in _fields(tcfg.ModelConfig).items():
        assert field in ref and ref[field] == default, field
    from repro.configs import paper_cnn as rpc
    from repro_torch.configs import paper_cnn as tpc
    for field in _fields(tcfg.ModelConfig):
        assert getattr(tpc.CONFIG, field) == getattr(rpc.CONFIG, field)
    assert tcfg.FAILURE_SCENARIOS == rcfg.FAILURE_SCENARIOS
    assert tcfg.MEMBERSHIP_SCENARIOS == rcfg.MEMBERSHIP_SCENARIOS


BAD_ELASTIC = [
    dict(comm_mode="ring"), dict(placement="mesh"),
    dict(placement="sharded"), dict(staleness=2), dict(staleness=1),
    dict(failure_scenario="flood"), dict(num_workers=0),
    dict(num_workers=4, capacity=2), dict(hetero_dist="pareto"),
    dict(hetero_sigma=0.0), dict(hetero_slow_frac=1.5),
    dict(hetero_slow_scale=0.0), dict(byzantine_frac=1.0),
    dict(byzantine_mode="lie"), dict(byzantine_scale=0.0),
    dict(score_clip=-1.0), dict(u_zclip=-0.5), dict(groups=0),
    dict(global_period=0), dict(num_workers=2, groups=3),
    dict(groups=2), dict(groups=2, comm_mode="fused", staleness=1),
    dict(membership_scenario="grow"), dict(membership_scenario="plan"),
    dict(membership_plan=((0, 9),)),
]


@pytest.mark.parametrize("kw", BAD_ELASTIC)
def test_same_bad_elastic_configs_raise(kw):
    with pytest.raises(ValueError) as want:
        rcfg.ElasticConfig(**kw)
    with pytest.raises(ValueError) as got:
        tcfg.ElasticConfig(**kw)
    assert str(got.value) == str(want.value)


def test_get_config_refuses_lm_families():
    """The ported archs resolve (paper-cnn; qwen3-4b, its SMOKE too; the
    three MoE archs; the encoder-decoder and the VLM); every LM family
    still outside the port (hybrid, rwkv6) raises naming itself."""
    assert tcfg.get_config("paper-cnn").name == "paper-cnn"
    assert tcfg.get_config("qwen3-4b").name == "qwen3-4b"
    assert tcfg.get_config("qwen3_4b", smoke=True).name == "qwen3-smoke"
    for arch in ("mixtral-8x22b", "llama4-scout-17b-a16e",
                 "moonshot-v1-16b-a3b"):
        assert tcfg.get_config(arch).name == arch
        assert tcfg.get_config(arch).family == "moe"
    for arch, family, smoke in (
            ("seamless-m4t-large-v2", "encdec", "seamless-smoke"),
            ("qwen2-vl-7b", "vlm", "qwen2-vl-smoke")):
        assert tcfg.get_config(arch).name == arch
        assert tcfg.get_config(arch).family == family
        assert tcfg.get_config(arch, smoke=True).name == smoke
    for arch in ("zamba2-7b", "rwkv6-3b"):
        with pytest.raises(NotImplementedError, match=arch):
            tcfg.get_config(arch)
