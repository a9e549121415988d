#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100 class).

    python3 chip_smoke.py

Runs from the root of a checkout, with no arguments, on one card; imports
nothing of JAX and nothing of the JAX package. Phases, each fatal on
failure:

1. environment: torch, CUDA, and the card's name and power limit;
2. build: nvcc compiles every ``src/repro_torch/csrc/*.cu`` for sm_90a,
   all sources at once;
3. kernels: each CUDA kernel at the main path's shapes (k=8 workers,
   n=1,199,882 parameters) against its plain PyTorch version on the same
   inputs, at the reference's tolerances, then timed with CUDA events
   (median of 30 after warm-up) beside the plain version and the byte
   bound of the card;
4. main path: the paper's §VI ``run_one`` for all six methods at k=4,
   τ=1, then DEAHES-O at k=8, τ=4 in both comm modes, with every launch
   count zeroed just before and read just after: each kernel must have
   run exactly as often as the path calls it, every loss must be finite;
5. devices: two DEAHES-O rounds on the card and on the CPU (plain
   versions) from the same carried params and probes; the masters agree;
6. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, ...}`` line.

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
# (memory B/s, f32 FLOP/s without tensor cores), NVIDIA data sheets
CARDS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}


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

    bw, flops = rates
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


def main_path(torch):
    """Phase 4: the §VI methods through ``run_one`` on the card."""
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
                "elastic_update_batched": rounds if comm == "fused" else 0}
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
    for name, count in totals.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never ran on the main path")
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
        f"{rates[1] / 1e12:.0f} TFLOP/s f32")

    t0 = time.perf_counter()
    libs = build()
    for kernel in kernels().values():
        kernel.load()
    log(f"[2] built {sorted(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")

    log(f"[3] kernels vs plain versions at k={K}, n={N}")
    table = check_kernels(torch, rates)

    log("[4] main path: paper_repro.run_one on the card")
    totals, _ = main_path(torch)
    log(f"    launches on the main path: {totals}")
    for entry in table:
        entry["launches"] = totals[entry["name"]]

    log("[5] card vs CPU, DEAHES-O, 2 rounds, carried params and probes")
    device_parity(torch)

    log(f"[6] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
