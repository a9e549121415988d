#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100 class).

    python3 chip_smoke.py

Runs from the root of a checkout, with no arguments, on one card; imports
nothing of JAX and nothing of the JAX package. Phases, each fatal on
failure:

1. environment: torch, CUDA, and the card's name and power limit;
2. build: nvcc compiles every ``src/repro_torch/csrc/*.cu`` for sm_90a,
   all sources at once;
3. kernels: each CUDA kernel at its path's shapes (the elastic kernels
   at k=8 workers, n=1,199,882 parameters; flash attention over the CPU
   tests' sweep and qwen3-4b's prefill, in float32 and bfloat16) against
   its plain PyTorch version on the same inputs, at the reference's
   tolerances, then timed with CUDA events (median of 30 after warm-up)
   beside the plain version, the card's bound and, for flash attention,
   ``scaled_dot_product_attention`` (timed only);
4. §VI path: the paper's ``run_one`` for all six methods at k=4, τ=1,
   then DEAHES-O at k=8, τ=4 in both comm modes, with every launch count
   zeroed just before and read just after: each of the three training
   kernels runs exactly as often as the path calls it, flash attention
   never, and every loss is finite;
5. devices: two DEAHES-O rounds on the card and on the CPU (plain
   versions) from the same carried params and probes; the masters agree;
6. serving path: qwen3-4b at full width (4,022,468,096 bf16 params drawn
   on the card) through ``launch/serve.py``'s continuous engine over a
   16-request bursty trace, counts zeroed just before: flash attention
   launches exactly admits x 36 times, no other kernel runs, every logit
   is finite; then one static ``ServeEngine`` batch, and (6b) a
   ``torch.profiler`` window over one decode tick and one admit;
7. serving devices: 2 layers at full width in float32 on the card and on
   the CPU from the same params, prefill and 4 decode steps agree;
8. a ``{"serving": ...}`` line, a ``{"kernels": [...]}`` line, the
   ``nvidia-smi`` line, and last the ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when torch sees no CUDA device or the
port's sources are not beside this script.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
K, N = 8, 1_199_882          # the §VI trainer at k=8: PaperCNN's n
# (memory B/s, f32 FLOP/s without tensor cores, dense bf16 tensor-core
# FLOP/s), NVIDIA data sheets
CARDS = {"H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12),
         "H200": (4.8e12, 67e12, 989e12), "H100": (3.35e12, 67e12, 989e12)}
# qwen3-4b's prefill in the continuous engine: B, H, KVH, S, D
SERVE_SHAPE = (1, 32, 8, 512, 128)
FLASH_SWEEP = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
               (1, 4, 2, 256, 128), SERVE_SHAPE]
SECTION_VI_KERNELS = ("adahessian_update_batched", "elastic_update_batched",
                      "elastic_update")
FLASH_MASKS = [dict(causal=True), dict(causal=False),
               dict(causal=True, window=17), dict(causal=True, window=96),
               dict(causal=True, chunk=64)]


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str):
    for key, rates in CARDS.items():
        if key in name:
            return key, rates
    raise RuntimeError(f"no memory/FLOP rates on record for {name!r}")


def median_ms(torch, fn, reps: int = 30, warm: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` calls. Each timed call
    is queued behind a ~5 ms GPU sleep, so the host has enqueued it before
    the start event fires: the events bracket device work only, not the
    host's launch latency (tens of µs through Python and ctypes)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        torch.cuda._sleep(10_000_000)  # GPU clock cycles
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def check_kernels(torch, rates):
    """Phase 3: every kernel against its plain version, then timed."""
    from repro_torch.kernels.adahessian import ops as ada
    from repro_torch.kernels.elastic import ops as ela
    from repro_torch.optim.adahessian import bias_corrections

    bw, flops, _ = rates
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    rnd = lambda *shape, s=1.0: s * torch.randn(*shape, generator=gen,
                                                 device=dev)

    def bound(nbytes, nops):
        b_ms, o_ms = nbytes / bw * 1e3, nops / flops * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    def max_err(got, want):
        return float((got - want).abs().max())

    out = []
    # -- K1: AdaHessian batched step -----------------------------------------
    p, g, h, m = rnd(K, N), rnd(K, N), rnd(K, N), rnd(K, N, s=0.1)
    v = rnd(K, N, s=0.1).abs()
    bc = bias_corrections(torch.arange(1, K + 1, device=dev) * 3,
                          (0.9, 0.999))
    kw = dict(lr=0.01, b1=0.9, b2=0.999, denom_pow=0.5, eps=1e-8, lrwd=0.0)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    ada.adahessian_update_batched(kp, g, h, km, kv, bc, **kw)
    ada.adahessian_update_batched_plain(p, g, h, m, v, bc, **kw)
    torch.cuda.synchronize()
    for got, want in ((kp, p), (km, m), (kv, v)):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    err = max(max_err(kp, p), max_err(km, m), max_err(kv, v))
    ms = median_ms(torch, lambda: ada.adahessian_update_batched(
        kp, g, h, km, kv, bc, **kw))
    plain_ms = median_ms(torch, lambda: ada.adahessian_update_batched_plain(
        p, g, h, m, v, bc, **kw))
    b_ms, b_by = bound(32 * K * N + 8 * K, 17 * K * N)
    out.append({"name": ada.KERNEL.name, "route": "cuda",
                "source": "src/repro_torch/csrc/adahessian.cu",
                "replaces": "src/repro/kernels/adahessian/kernel.py:125",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    del p, g, h, m, v, kp, km, kv
    # -- K2: elastic batched exchange, stale off and on ----------------------
    w, mm, ref = rnd(K, N), rnd(N), rnd(N)
    hw = torch.rand(2, K, generator=gen, device=dev) * 0.3
    entry = {"name": ela.BATCHED_KERNEL.name, "route": "cuda",
             "source": "src/repro_torch/csrc/elastic.cu",
             "replaces": "src/repro/kernels/elastic/kernel.py:107",
             "library_ms": None}
    for stale in (False, True):
        r = ref if stale else None
        kw_, km_ = w.clone(), mm.clone()
        ela.elastic_update_batched(kw_, km_, hw, r)
        pw, pm = w.clone(), mm.clone()
        ela.elastic_update_batched_plain(pw, pm, hw, r)
        torch.cuda.synchronize()
        torch.testing.assert_close(kw_, pw, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(km_, pm, rtol=1e-5, atol=1e-6)
        err = max(max_err(kw_, pw), max_err(km_, pm))
        ms = median_ms(torch, lambda: ela.elastic_update_batched(
            kw_, km_, hw, r))
        plain_ms = median_ms(torch, lambda: ela.elastic_update_batched_plain(
            pw, pm, hw, r))
        b_ms, b_by = bound((2 * K + 2 + stale) * 4 * N + 8 * K,
                           (5 * K + 1) * N)
        tag = "stale_" if stale else ""
        entry.update({f"{tag}max_abs_err": err, f"{tag}ms": ms,
                      f"{tag}plain_ms": plain_ms, f"{tag}bound_ms": b_ms})
        entry.setdefault("bound_by", b_by)
        del kw_, km_, pw, pm
    out.append(entry)
    # -- K3: one worker's exchange, rotating over the k worker rows as the
    #    sequential scan does (a row is 4.8 MB: the master stays in L2) --
    hk = torch.tensor([[0.25], [0.07]], device=dev)
    kw_, km_ = w.clone(), mm.clone()
    ela.elastic_update(kw_[0], km_, hk)
    pw, pm = w.clone(), mm.clone()
    ela.elastic_update_plain(pw[0], pm, hk)
    torch.cuda.synchronize()
    torch.testing.assert_close(kw_[0], pw[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(km_, pm, rtol=1e-6, atol=1e-6)
    err = max(max_err(kw_[0], pw[0]), max_err(km_, pm))
    row = iter(range(10 ** 9))
    ms = median_ms(torch, lambda: ela.elastic_update(
        kw_[next(row) % K], km_, hk))
    plain_ms = median_ms(torch, lambda: ela.elastic_update_plain(
        pw[next(row) % K], pm, hk))
    b_ms, b_by = bound(16 * N + 8, 6 * N)
    out.append({"name": ela.KERNEL.name, "route": "cuda",
                "source": "src/repro_torch/csrc/elastic.cu",
                "replaces": "src/repro/kernels/elastic/kernel.py:39",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for e in out:
        log(f"  {e['name']}: max_abs_err {e['max_abs_err']:.3g}, kernel "
            f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']})"
            + (f"; stale: err {e['stale_max_abs_err']:.3g}, kernel "
               f"{e['stale_ms']:.4f} ms, plain {e['stale_plain_ms']:.4f} "
               f"ms, bound {e['stale_bound_ms']:.4f} ms"
               if "stale_ms" in e else ""))
    log("  library_ms: none — no single PyTorch call computes any of "
        "these three functions")
    return out


def check_flash(torch, rates):
    """Phase 3b: the flash-attention kernel against its plain version over
    the CPU tests' sweep and the serving shape, float32 and bfloat16, at
    the reference's tolerances; then timed at the serving shape beside the
    plain version, the byte/operation bound, and one library call
    (``scaled_dot_product_attention``, timed only, never used by the
    port)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fla

    bw, f32_rate, bf16_rate = rates
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

    def qkv(B, H, KVH, S, D, dtype):
        return (torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype),
                torch.randn(B, S, KVH, D, generator=gen, device=dev).to(dtype),
                torch.randn(B, S, KVH, D, generator=gen, device=dev).to(dtype))

    sweep_err = {}
    for dtype, tol in tols.items():
        worst = 0.0
        for shape in FLASH_SWEEP:
            q, k, v = qkv(*shape, dtype)
            for mask in FLASH_MASKS:
                got = fla.flash_attention_bshd(q, k, v, **mask)
                want = fla.flash_attention_plain(q, k, v, **mask)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                worst = max(worst, float((got.float() - want.float())
                                         .abs().max()))
        sweep_err[str(dtype).removeprefix("torch.")] = worst
    log(f"  flash_attention_fwd: {len(FLASH_SWEEP)} shapes x "
        f"{len(FLASH_MASKS)} masks, max abs err vs plain {sweep_err}")

    B, H, KVH, S, D = SERVE_SHAPE
    pos = torch.arange(S)
    live_pairs = int((pos[None, :] <= pos[:, None]).sum())  # causal
    entry = {"name": fla.KERNEL.name, "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:97",
             "shape_bshd": [B, S, H, KVH, D], "sweep_max_abs_err": sweep_err}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv(*SERVE_SHAPE, dtype)
        got = fla.flash_attention_bshd(q, k, v)
        want = fla.flash_attention_plain(q, k, v)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        lib_err = float((lib.transpose(1, 2).float() - want.float())
                        .abs().max())
        ms = median_ms(torch, lambda: fla.flash_attention_bshd(q, k, v))
        plain_ms = median_ms(torch, lambda: fla.flash_attention_plain(q, k, v))
        lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = (2 * B * S * H * D + 2 * B * S * KVH * D) * q.element_size()
        nops = 4 * D * live_pairs * B * H
        rate = bf16_rate if dtype == torch.bfloat16 else f32_rate
        b_ms, o_ms = nbytes / bw * 1e3, nops / rate * 1e3
        bound = (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")
        tag = "" if dtype == torch.bfloat16 else "f32_"
        entry.update({f"{tag}max_abs_err": err, f"{tag}ms": ms,
                      f"{tag}plain_ms": plain_ms, f"{tag}bound_ms": bound[0],
                      f"{tag}bound_by": bound[1], f"{tag}library_ms": lib_ms})
        log(f"  flash_attention_fwd {str(dtype).removeprefix('torch.')} at "
            f"B,H,KVH,S,D={SERVE_SHAPE} causal: max_abs_err {err:.3g} "
            f"(sdpa vs plain {lib_err:.3g}), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound[0]:.4f} "
            f"ms ({bound[1]}: {nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} GFLOP)")
    return entry


def main_path(torch):
    """Phase 4: the §VI methods through ``run_one`` on the card. Each run
    launches exactly its path's kernels (no flash attention here)."""
    import math

    from repro_torch.experiments.paper_repro import METHODS, run_one
    from repro_torch.kernels import kernels, reset_launch_counts

    runs = [(m, 4, 1, "sequential", 8) for m in METHODS] + [
        ("DEAHES-O", 8, 4, "sequential", 4), ("DEAHES-O", 8, 4, "fused", 4)]
    per_run = []
    reset_launch_counts()
    for method, k, tau, comm, rounds in runs:
        before = {n: x.launches for n, x in kernels().items()}
        res = run_one(method, k, tau, rounds=rounds, eval_every=rounds // 2,
                      comm_mode=comm, device="cuda")
        moved = {n: x.launches - before[n] for n, x in kernels().items()}
        hess = METHODS[method][0] == "adahessian"
        want = {"adahessian_update_batched": rounds * tau if hess else 0,
                "elastic_update": rounds * k if comm == "sequential" else 0,
                "elastic_update_batched": rounds if comm == "fused" else 0,
                "flash_attention_fwd": 0}
        losses = res["curves"]["train_loss"] + res["curves"]["test_loss"]
        steady = statistics.median(res["round_ms"][1:])
        log(f"  {method:9s} k={k} tau={tau} {comm:10s} rounds={rounds}: "
            f"final train loss {res['curves']['train_loss'][-1]:.4f}, "
            f"test loss {res['curves']['test_loss'][-1]:.4f}, test acc "
            f"{res['final_acc']:.4f}, round ms {steady:.2f} (first "
            f"{res['round_ms'][0]:.1f}), launches {moved}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{method} {comm}: non-finite loss {losses}")
        if moved != want:
            raise AssertionError(f"{method} {comm}: launches {moved}, "
                                 f"expected {want}")
        per_run.append({"method": method, "k": k, "tau": tau, "comm": comm,
                        "rounds": rounds, "round_ms": steady,
                        "launches": moved})
    totals = {n: x.launches for n, x in kernels().items()}
    for name in SECTION_VI_KERNELS:
        if totals[name] == 0:
            raise AssertionError(f"kernel {name} never ran on the §VI path")
    return totals, per_run


def device_parity(torch):
    """Phase 5: the card (kernels) and the CPU (plain versions) from the
    same carried params and probes. Masters agree per leaf norm-wise to
    1e-4, and elementwise to rtol 1e-4 with an atol of 2% of the leaf's
    scale: a max-pool window whose two largest conv outputs are within a
    few ulps can pick a different winner on the two devices, which moves
    one fc1 row's AdaHessian preconditioner (tests/test_torch_session.py
    measures it)."""
    import numpy as np

    from repro_torch.api.session import ElasticSession, RunSpec
    from repro_torch.configs.base import ElasticConfig, OptimizerConfig
    from repro_torch.kernels.flatten import FlatLayout
    from repro_torch.models.cnn import PaperCNN
    from repro_torch.configs.base import get_config
    from repro_torch.nn.param import init_tree

    spec_tree = PaperCNN(get_config("paper-cnn")).spec
    layout = FlatLayout(spec_tree)
    params = init_tree(torch.Generator().manual_seed(3), spec_tree)

    def probes(device):
        def fn(r, t, i):
            rng = np.random.default_rng([11, r, t, i])
            z = rng.integers(0, 2, (1, layout.n)).astype(np.float32) * 2 - 1
            return torch.from_numpy(z).to(device)
        return fn

    for comm in ("sequential", "fused"):
        masters = {}
        for device in ("cuda", "cpu"):
            spec = RunSpec(
                optimizer=OptimizerConfig(name="adahessian"),
                elastic=ElasticConfig(num_workers=4, tau=1, comm_mode=comm),
                rounds=2, batch_size=32, n_data=2000, n_test=100,
                device=device)
            sess = ElasticSession(spec, params=params,
                                  probe_fn=probes(device))
            sess.run()
            masters[device] = sess.state["master"].cpu().double()
        worst_norm, worst_abs = 0.0, 0.0
        for leaf in layout.leaves:
            sl = slice(leaf.offset, leaf.offset + leaf.size)
            got, want = masters["cuda"][sl], masters["cpu"][sl]
            torch.testing.assert_close(
                got, want, rtol=1e-4,
                atol=2e-2 * float(want.abs().max()))
            rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
            if rel > 1e-4:
                raise AssertionError(f"{comm} {leaf.name}: cuda vs cpu "
                                     f"master norm-wise {rel:.2e} > 1e-4")
            worst_norm = max(worst_norm, rel)
            worst_abs = max(worst_abs, float((got - want).abs().max()))
        log(f"  DEAHES-O {comm}: cuda vs cpu master max abs err "
            f"{worst_abs:.3g}, worst leaf norm-wise {worst_norm:.3g}")


class WatchedLM:
    """Wraps a ``DecoderLM`` for the engines: every ``prefill`` /
    ``decode_step`` is timed between two ``synchronize()`` calls (the
    engines read their tokens back after each call anyway), and whether
    every logit was finite is kept in one device flag, read at the end."""

    def __init__(self, torch, model):
        self.torch, self.model, self.cfg = torch, model, model.cfg
        self.times = {"prefill": [], "decode": []}
        self.finite = None

    def init_cache(self, *args, **kw):
        return self.model.init_cache(*args, **kw)

    def _call(self, kind, fn, *args):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*args)
        torch.cuda.synchronize()
        self.times[kind].append(time.perf_counter() - t0)
        ok = torch.isfinite(logits).all()
        self.finite = ok if self.finite is None else self.finite & ok
        return logits, cache

    def prefill(self, params, batch, cache):
        return self._call("prefill", self.model.prefill, params, batch, cache)

    def decode_step(self, params, batch, cache, index):
        return self._call("decode", self.model.decode_step, params, batch,
                          cache, index)


def serving_path(torch):
    """Phase 6: qwen3-4b at full width, bf16, weights drawn on the card from
    a seed, served through the entry points of ``launch/serve.py``: the
    continuous engine at capacity 8 over the 16-request bursty trace
    (prompts of 256 and 512 tokens, 64 new tokens each; ``prefill_len``
    512, ``max_len`` 577), launch counts zeroed just before and read just
    after; then one static ``ServeEngine`` batch (8 x 512, 32 steps)."""
    import argparse

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import kernels, reset_launch_counts
    from repro_torch.launch.serve import serve_continuous, serve_static
    from repro_torch.models.registry import build_model
    from repro_torch.nn.param import init_tree, param_count

    dev = torch.device("cuda")
    cfg = get_config("qwen3-4b")
    model = build_model(cfg)
    n_params = param_count(model.spec)
    if n_params != 4_022_468_096:
        raise AssertionError(f"qwen3-4b has {n_params:,} params")
    t0 = time.perf_counter()
    params = init_tree(torch.Generator(dev).manual_seed(0), model.spec, dev)
    torch.cuda.synchronize()
    log(f"  qwen3-4b: {n_params:,} params ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.kv_heads} heads of {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}) drawn on "
        f"the card in {time.perf_counter() - t0:.3f} s")

    lm = WatchedLM(torch, model)
    args = argparse.Namespace(capacity=8, prompt_len=512, steps=64,
                              traffic=16, eos_id=None, poll_every=8,
                              batch=8)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sched, results = serve_continuous(lm, params, args, cfg.vocab_size)
    wall = time.perf_counter() - t0
    launches = {n: x.launches for n, x in kernels().items()}
    admits = len(lm.times["prefill"])
    want = {n: 0 for n in launches}
    want["flash_attention_fwd"] = admits * cfg.num_layers
    if launches != want:
        raise AssertionError(f"serving launches {launches}, expected {want}")
    if not bool(lm.finite):
        raise AssertionError("a non-finite logit on the serving path")
    served = [r for r in results if r.reason != "rejected"]
    if len(served) != 16 or admits != 16:
        raise AssertionError(f"served {len(served)}/16, {admits} admits")
    if any(r.num_tokens != 64 for r in served):
        raise AssertionError("a request ended short of 64 tokens")
    toks = sum(r.num_tokens for r in served)
    ttft = np.array([r.ttft for r in served]) * 1e3
    lat = np.array([r.latency for r in served]) * 1e3
    stats = {
        "served": len(served), "requests": len(results), "tokens": toks,
        "virtual_s": sched.vnow, "wall_s": wall, "tok_s": toks / sched.vnow,
        "req_s": len(served) / sched.vnow,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "ticks": sched.engine.ticks,
        "prefill_ms_median": 1e3 * statistics.median(lm.times["prefill"]),
        "decode_tick_ms_median": 1e3 * statistics.median(lm.times["decode"]),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "flash_launches": launches["flash_attention_fwd"],
    }
    log(f"  continuous: served {len(served)}/{len(results)}, {toks} tokens, "
        f"{stats['tok_s']:.1f} tok/s over {sched.vnow:.3f} s virtual "
        f"({wall:.3f} s wall), TTFT p50 {stats['ttft_ms_p50']:.1f} / p99 "
        f"{stats['ttft_ms_p99']:.1f} ms, latency p50 "
        f"{stats['latency_ms_p50']:.1f} / p99 {stats['latency_ms_p99']:.1f} "
        f"ms; {stats['ticks']} decode ticks of median "
        f"{stats['decode_tick_ms_median']:.2f} ms, prefill median "
        f"{stats['prefill_ms_median']:.2f} ms; flash launches "
        f"{launches['flash_attention_fwd']} = {admits} admits x "
        f"{cfg.num_layers} layers; peak memory "
        f"{stats['max_memory_allocated_gb']:.2f} GB")

    lm = WatchedLM(torch, model)
    static = argparse.Namespace(batch=8, prompt_len=512, steps=32,
                                eos_id=None)
    reset_launch_counts()
    tok_s = serve_static(lm, params, static, cfg.vocab_size, dev)
    moved = {n: x.launches for n, x in kernels().items()}
    if any(moved.values()):  # prefill into a longer cache: no flash branch
        raise AssertionError(f"static serving launched {moved}")
    if not bool(lm.finite):
        raise AssertionError("a non-finite logit in the static batch")
    decode = lm.times["decode"][-31:]  # the second trial's 31 decode steps
    stats.update({"static_tok_s": tok_s,
                  "static_decode_tok_s": 8 * len(decode) / sum(decode),
                  "static_decode_step_ms_median":
                      1e3 * statistics.median(decode),
                  "static_prefill_ms": 1e3 * lm.times["prefill"][-1]})
    log(f"  static: 8 x 512 prompt, 32 steps: {tok_s:.1f} tok/s end to end, "
        f"decode {stats['static_decode_tok_s']:.1f} tok/s (step median "
        f"{stats['static_decode_step_ms_median']:.2f} ms), prefill "
        f"{stats['static_prefill_ms']:.2f} ms")
    log("[6b] profiler: one decode tick and one admit's prefill")
    stats["profile"] = profile_serving(torch, model, params)
    del params
    torch.cuda.empty_cache()
    return launches, stats


def profile_serving(torch, model, params):
    """Phase 6b: where a decode tick and an admit spend their time. One
    ``torch.profiler`` window over 3 pooled decode steps (capacity 8, every
    row at position 512 of a 577-position cache) and one over 1 prefill of
    512 tokens; device busy share = the union of kernel intervals over the
    window's wall time, closed by ``synchronize()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cache = model.init_cache(8, 577, dev)
    tok = torch.zeros(8, 1, dtype=torch.long, device=dev)
    idx = torch.full((8, 1), 512, device=dev)
    prompt = torch.zeros(1, 512, dtype=torch.long, device=dev)
    scratch = model.init_cache(1, 512, dev)
    calls = {
        "decode tick": (3, lambda: model.decode_step(
            params, {"tokens": tok}, cache, idx)),
        "admit prefill": (1, lambda: model.prefill(
            params, {"tokens": prompt}, scratch)),
    }
    out = {}
    with torch.no_grad():
        for name, (reps, fn) in calls.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            spans = sorted((e.time_range.start, e.time_range.end, e.name)
                           for e in prof.events()
                           if e.device_type == DeviceType.CUDA)
            busy, end, by_name = 0.0, float("-inf"), {}
            for start, stop, kname in spans:
                busy += max(0.0, stop - max(start, end))
                end = max(end, stop)
                by_name[kname] = by_name.get(kname, 0.0) + stop - start
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
            out[name] = {"wall_ms": wall_us / reps / 1e3,
                         "device_busy_ms": busy / reps / 1e3,
                         "device_busy_share": busy / wall_us,
                         "kernels": len(spans) // reps}
            log(f"  {name}: {wall_us / reps / 1e3:.2f} ms wall, device busy "
                f"{busy / reps / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
                f"{len(spans) // reps} kernels; top device time: "
                + "; ".join(f"{k[:60]} {v / reps / 1e3:.3f} ms"
                            for k, v in top))
    return out


def serving_device_parity(torch):
    """Phase 7: the serving path on the card (flash kernel) and on the CPU
    (plain versions) from the same params: qwen3-4b at full width cut to 2
    layers, float32. Prefill 512 tokens into a 512-position cache (the
    flash branch, as an admit), adopt the cache into 516 positions, then 4
    greedy decode steps fed the CPU's tokens. Logits agree within 1e-3 of
    the logit scale (max |logit|): float32 matmuls in other summation
    orders over d_model 2560 and d_ff 9728."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.nn.param import init_tree, tree_from_leaves, tree_leaves

    cfg = get_config("qwen3-4b").replace(num_layers=2, dtype="float32",
                                         param_dtype="float32")
    model = build_model(cfg)
    cpu = init_tree(torch.Generator().manual_seed(1), model.spec)
    card = tree_from_leaves((p, t.cuda()) for p, t in tree_leaves(cpu))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 512))
    S = toks.shape[1]
    outs = {}
    feed = []
    for dev, params in (("cpu", cpu), ("cuda", card)):
        with torch.no_grad():
            batch = {"tokens": torch.as_tensor(toks, device=dev)}
            logits, scratch = model.prefill(params, batch,
                                            model.init_cache(1, S, dev))
            cache = model.init_cache(1, S + 4, dev)
            for key in ("k", "v"):
                cache["dense"][key][:, :, :S] = scratch["dense"][key]
            steps = [logits.float().cpu()]
            for i in range(4):
                if dev == "cpu":
                    feed.append(steps[-1][:, -1:].argmax(-1))
                logits, cache = model.decode_step(
                    params, {"tokens": feed[i].to(dev)}, cache, S + i)
                steps.append(logits.float().cpu())
        outs[dev] = steps
    worst = 0.0
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not bool(torch.isfinite(a).all()) or err > 1e-3 * scale:
            raise AssertionError(f"serving card vs CPU, call {i}: max abs "
                                 f"err {err:.3g} > 1e-3 x {scale:.3g}")
        worst = max(worst, err / scale)
        log(f"  {'prefill' if i == 0 else f'decode {i}'}: max abs err "
            f"{err:.3g} (logit scale {scale:.3g})")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import kernels
    from repro_torch.kernels.build import build

    t_start = time.perf_counter()
    resolve_device("cuda")  # TF32 off for matmuls and cuDNN
    smi = nvidia_smi_line()
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    card, rates = card_rates(smi.split(",")[0])
    log(f"    rates of record for {card}: {rates[0] / 1e12:.2f} TB/s, "
        f"{rates[1] / 1e12:.0f} TFLOP/s f32, {rates[2] / 1e12:.0f} TFLOP/s "
        "dense bf16")

    t0 = time.perf_counter()
    libs = build()
    for kernel in kernels().values():
        kernel.load()
    log(f"[2] built {sorted(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")

    log(f"[3] kernels vs plain versions at k={K}, n={N}")
    table = check_kernels(torch, rates)
    log(f"[3b] flash attention vs plain version, {len(FLASH_SWEEP)} shapes")
    table.append(check_flash(torch, rates))

    log("[4] §VI path: paper_repro.run_one on the card")
    totals, _ = main_path(torch)
    log(f"    launches on the §VI path: {totals}")

    log("[5] card vs CPU, DEAHES-O, 2 rounds, carried params and probes")
    device_parity(torch)

    log("[6] serving path: qwen3-4b at full width through launch/serve.py")
    serve_counts, serve_stats = serving_path(torch)
    for entry in table:
        name = entry["name"]
        entry["launches"] = (serve_counts if name == "flash_attention_fwd"
                             else totals)[name]

    log("[7] serving card vs CPU: qwen3-4b width, 2 layers, float32")
    serve_stats["card_vs_cpu_rel_err"] = serving_device_parity(torch)

    log(f"[8] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serving": serve_stats}))
    print(json.dumps({"kernels": table}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
