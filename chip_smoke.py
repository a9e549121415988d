#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100 class).

    python3 chip_smoke.py

Runs from the root of a checkout, with no arguments, on one card; imports
nothing of JAX and nothing of the JAX package. Phases, each fatal on
failure:

1. environment: torch, CUDA, and the card's name and power limit;
2. build: nvcc compiles every ``src/repro_torch/csrc/*.cu`` for sm_90a,
   all sources at once; the flash-attention library's SASS must hold
   HGMMA (tensor-core) instructions of both kernels, bf16 and TF32,
   counted with ``cuobjdump``;
3. kernels: each CUDA kernel at its path's shapes (the elastic kernels
   at k=8 workers, n=1,199,882 parameters, the batched exchange and the
   single-worker AdaHessian step also at an odd n; flash attention over
   the CPU tests' sweep, qwen3-4b's prefill and the LM evals' shapes, in
   float32 (split TF32) and bfloat16, both on the tensor cores) against its
   plain PyTorch version on the same inputs, at the reference's
   tolerances, then timed with CUDA events (median of 30 after warm-up)
   beside the plain version, the card's bound and, for flash attention,
   ``scaled_dot_product_attention`` (timed only); flash attention also at
   the MoE admits in bf16 (moonshot-v1-16b-a3b's (1, 16, 16, 512, 128)
   causal, mixtral-8x22b's S=8192 with its window of 4096, scout's
   S=12288 with its chunk of 8192), held to plain one kv head at a time,
   elementwise (2e-2) and each (query row, head) norm-wise (1e-2 of the
   row's norm; 1e-4 in float32), with plain versions whose window or
   chunk is one 64-key tile shorter or longer shown to fail that check,
   and timed beside SDPA with the same mask; and at the new families'
   calls, held and timed the same way: seamless-m4t-large-v2's encoder
   (4, 16, 16, 512, 64) non-causal and qwen2-vl-7b's forward (1, 28, 4,
   1152, 128) causal;
4. §VI path: the paper's ``run_one`` for all six methods at k=4, τ=1,
   then DEAHES-O at k=8, τ=4 in both comm modes, with every launch count
   zeroed just before and read just after: each of the three training
   kernels runs exactly as often as the path calls it, flash attention
   never, and every loss is finite;
5. devices: two DEAHES-O rounds on the card and on the CPU (plain
   versions) from the same carried params and probes; the masters agree;
5b. training CLI: ``launch/train.py``'s ``main`` at the paper's full
   width, counts zeroed just before each run and read just after:
   DEAHES-O defaults at k=8, τ=4 for 8 rounds with ``--save`` (the saved
   master read back bit for bit, then a 2-round warm start from it),
   ``--plain`` for 50 steps (50 launches of the single-worker AdaHessian
   kernel, none of the batched one), and 4 rounds each of the byzantine
   (noise, ``--score-clip 3`` and ``--score-clip 4``: live corrupt slots
   refused in every round, and at clip 4 every live honest slot accepted
   once the scores have warmed up), hetero (τ=4) and ``--u-zclip 3``
   runs;
5c. plain devices: three plain-mode steps on the card and on the CPU
   from the same carried params and probes; params agree per leaf;
5d. membership: ``main`` at full width with 8 slots, DEAHES-O, τ=4, 8
   rounds: 4 live scaled up to 8 at round 3 (both comm modes), then
   preempt_rejoin (slots 6, 7 out for rounds 3-5); launch counts as the
   path calls them (the batched AdaHessian step over all 8 rows each
   τ-step, the exchange over all 8 slots), vacant slots' params
   bit-unchanged, joiners equal to the master when they start, vacant
   records zero, the live count per round as scheduled;
5e. closed-loop control: ``--controller rules`` under crash_restart, 8
   slots, 12 rounds, open and ``--detector-blind``: the journal printed,
   the live mask after each applied action as the action says, evicted
   slots frozen while out;
5f. membership devices: 4 rounds at capacity 6, 4 live scaled up to 6,
   card against CPU from the same params and probes; masters agree;
5g. the §VI grid: two ``paper_repro`` jobs on the card through
   ``experiments/grid.py``'s ``run_pool``, then ``report.repro_tables``;
5h. hierarchy: ``main`` at full width, DEAHES-O fused, τ=4, 8 rounds, 16
   slots in 4 racks with a global sync every 2 rounds (``--groups 4
   --global-period 2``), in turns with the flat fused k=16 run (flat,
   hierarchical, hierarchical, flat): the batched AdaHessian step 32
   times, the batched exchange once per rack per round and once per
   global sync (36; flat: 8), the round ms of both; ``--save`` read back
   (sub-masters bit for bit) and a 2-round warm start at 2 racks; a
   correlated-failure run whose outages darken racks at global syncs:
   every dark rack refused there (g_h1 = g_h2 = 0) with its sub-master
   bit-unchanged (``RackWatch``); card vs CPU at capacity 7 in racks of
   3/2/2, master and sub-masters at phase 5's tolerance;
5p. sharded placement: ``main`` at full width, DEAHES-O fused, τ=4, 8
   rounds: ``--placement sharded`` at world size 1 beside single placement
   (masters bit for bit, K1 32 and K2 8 launches each); then two processes
   of this script (``--sharded-rank``) as two ranks on the one card over
   gloo with CUDA tensors, through ``--coordinator-address``,
   ``--num-processes 2``, ``--process-id``: k=8 flat (K1 32 launches on
   each rank's 4 rows, K2 8 on the gathered 8; final master l2 and master
   identical on both ranks; against single placement the max abs
   difference, bit-exact or within phase 5's tolerance; round ms and the
   worker gather's ms and bytes per round), then 7 workers padded to 8
   slots in racks 3/3/2 with a global sync every 2 rounds (masters and
   sub-masters identical across ranks, within phase 5h's tolerance of
   single placement, g_h2 on sync rounds only); NCCL with one card per
   rank only where two or more cards are visible;
6. serving path: qwen3-4b at full width (4,022,468,096 bf16 params drawn
   on the card) through ``launch/serve.py``'s continuous engine over a
   16-request bursty trace, counts zeroed just before: flash attention
   launches exactly admits x 36 times, no other kernel runs, every logit
   is finite; then one static ``ServeEngine`` batch, and (6b) a
   ``torch.profiler`` window over one decode tick and one admit;
6s. stablelm-3b at full size (2,795,443,200 bf16 params: LayerNorm, 25%
   rotary, untied) through ``serve_continuous``: 16 bursty requests,
   prompts of 1024 and 2048 padded to 2048, 64 new tokens, capacity 8;
   counts zeroed just before: ``blockwise_attention`` admits x 32 times
   (10 of 16 block pairs each), no kernel launched (head_dim 80), every
   logit finite; one static batch at prompt 512 (``gqa_attention``, no
   blockwise call); a ``torch.profiler`` window over one admit;
6d. h2o-danube-1.8b at full size (1,831,201,280 params: window 4096,
   untied): 8 requests, prompts of 4096 and 8192 padded to 8192, 32 new
   tokens, capacity 4: blockwise admits x 24 times, 108 of 256 block
   pairs each (the window masks), no kernel, every logit finite; a
   profiler window over one admit;
6m. moonshot-v1-16b-a3b at full size (28,386,592,768 bf16 params drawn
   on the card; 1 dense + 47 MoE layers of 64 experts, top-6, 2 shared)
   through ``serve_continuous``: 8 bursty requests, prompts of 256 and 512
   padded to 512, 32 new tokens, capacity 4; counts zeroed just before:
   flash attention admits x 48 times, every call at (1, 512) bf16 causal,
   nothing else launched, ``apply_moe`` 47 times per admit and per tick,
   every logit finite; tok/s, TTFT, latency, admit and tick ms, peak GB;
   a profiler window over one tick and one admit;
6x. mixtral-8x22b (prompt 8192, twice its window of 4096) and
   llama4-scout-17b-a16e (prompt 12288, past its chunk of 8192) at full
   width cut to 2 layers, bf16, 2 requests of 8 new tokens at capacity 2:
   flash attention admits x 2 with the window or the chunk passed,
   ``apply_moe`` twice per admit and per tick, every logit finite;
6e. seamless-m4t-large-v2 at full size (2,034,784,256 bf16 params, 24
   encoder + 24 decoder layers) through ``ServeEngine.generate`` with
   ``extra_batch={"src": ...}``: 4 requests of 128 prompt tokens and 512
   frame embeddings (a numpy seed), 32 new tokens, two trials; counts
   zeroed just before: K5 24 times a prefill, every call non-causal at
   (4, 512, 16, 16, 64) (the encoder; the decoder's prefill, its
   cross-attention and the ticks take ``gqa_attention``), nothing else;
   tok/s, prefill and tick ms, peak GB; a profiler window over one
   prefill and one tick;
6v. qwen2-vl-7b at full size (7,615,487,488 bf16 params): (a)
   ``launch/serve.py``'s static mode, text-only, 8 x 128 prompts, 32 new,
   no K5; (b) one request of 1024 patch embeddings and 128 text tokens:
   ``VLM.forward`` with K5 28 times causal at (1, 1152, 28, 4, 128) under
   M-RoPE, then ``VLM.prefill`` and 32 ``decode_step``s at the global
   index; forward's last logits within 0.06 of their norm of the
   prefill's; a profiler window over one forward and one tick;
8a. LM training (run before 6w, which uses its session): qwen3-4b at
   full width cut to 4 layers (792,681,984 float32 params) through
   ``RunSpec`` / ``ElasticSession``, AdaHessian, DEAHES-O, k=2, τ=1,
   128-token windows, batch 2, fused comm, an eval every round; counts
   zeroed just before 4 rounds: K1 and K2 once a round, flash attention 4
   times an eval (``no_grad``), nothing else; round ms, dispatch share,
   peak GB, losses; a profiler window over one more round;
6w. hot-swap: the engine (qwen3-4b at full width cut to 4 layers, bf16)
   watches the directory the live 8a session saves into: a baseline
   master, a ``CheckpointWatcher`` on the continuous engine under a
   ``Scheduler`` (``poll_every`` 8), and at tick 10 the session trains
   one more round and saves: exactly one swap, at tick 16, the engine's
   params the session's master cast leaf for leaf; in-flight tokens
   unchanged, every request drained to its budget; post-swap tokens bit
   for bit those of a fresh engine restored from the same checkpoint;
   flash launches admits x 4 plus the round's eval; a checkpoint of
   another arch journalled once and skipped; checkpoint bytes, restore,
   flip and polling-tick times printed;
7. serving devices: 2 layers at full width in float32 on the card and on
   the CPU from the same params, prefill and 4 decode steps agree;
7b. blockwise devices: ``blockwise_attention`` at danube's admit shape
   (S=8192, window 4096) in float32 and bfloat16 against
   ``naive_attention`` on the card, one kv head at a time (3e-5 / 2e-2),
   timed at that shape and at stablelm-3b's (S=2048) beside
   ``scaled_dot_product_attention`` with the same mask (timed only); then
   phase 7 for stablelm-3b and h2o-danube-1.8b at 1024 tokens (the
   blockwise branch);
7m. phase 7 for moonshot-v1-16b-a3b at full width cut to 2 layers (1
   dense + 1 MoE, 1,344,940,032 float32 params): K5 once a layer in the
   card's prefill, logits within 1e-3 of the logit scale, and every
   router call's chosen experts equal on both devices (a differing token
   only where its router margin is within the devices' disagreement);
7e. phase 7 for seamless-m4t-large-v2 at full width cut to 2 encoder + 2
   decoder layers (128 frames, 128 tokens): K5 2 times non-causal in the
   encoder, then causal in each decoder layer's self-attention and
   non-causal in its cross-attention, on the card's prefill;
7v. phase 7 for qwen2-vl-7b at full width cut to 2 layers, 64 patches
   (a grid of 8) before 192 text tokens, M-RoPE sections (16, 24, 24):
   K5 once a layer, causal;
8b. ``repro_torch.examples.train_lm_elastic --preset 100m`` (the
   reference's preset for real hardware: 12 layers, head_dim 64, 512
   tokens, batch 16) at k=4, τ=2, 3 rounds, sequential comm, an eval
   every round; counts zeroed just before: K1 once a τ-step, K3 once a
   worker a round, flash attention 12 times an eval, nothing else;
8c. LM training card vs CPU at SMOKE (float32): stablelm-3b (fused) and
   qwen3-4b with head_dim 64 at 128 tokens (sequential; its eval takes
   the flash kernel), 3 rounds, the same params and probes; master and
   workers per leaf (norm-wise 1e-3, rtol 1e-4 with atol 2% of the
   leaf's scale), losses at rtol 1e-4;
8d. gradients: ``flash_attention_bshd`` on CUDA tensors raises under
   autograd and ``torch.func.grad``, launching nothing; a flash-shaped
   ``DecoderLM.loss(...).backward()`` at SMOKE gives every leaf the CPU's
   gradient within 1e-3 of its scale, with no flash launch under grad;
8e. MoE LM training card vs CPU at SMOKE (float32), 8c's rules at τ=1,
   128 tokens, 3 rounds: moonshot-smoke (fused: K1 and K2 once a round)
   and mixtral-smoke (sequential: K1 once a round, K3 once a worker a
   round);
9. a ``{"train_cli": ...}`` line, a ``{"serving": ...}`` line, a
   ``{"membership": ...}`` line, a ``{"control": ...}`` line, a
   ``{"hierarchy": ...}`` line, a ``{"sharded": ...}`` line, a
   ``{"dense_family": ...}`` line, a ``{"hotswap": ...}`` line, a
   ``{"lm_training": ...}`` line (8a-8e), a ``{"moe": ...}`` line (6m,
   6x, 7m), a ``{"families": ...}`` line (6e, 6v, 7e, 7v), a
   ``{"kernels": [...]}`` line (the batched kernels' entries
   with their launches on the hierarchy run and on each rank of the
   sharded runs too, every entry with its launches in phase 6w, in 8a-8e,
   in 6m, 6x and 7m and in 6e, 6v, 7e and 7v), the
   ``nvidia-smi`` line, and last the ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when torch sees no CUDA device or the
port's sources are not beside this script.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
K, N = 8, 1_199_882          # the §VI trainer at k=8: PaperCNN's n
N_ODD = 999_983              # an odd n for the single-worker step
# (memory B/s, f32 FLOP/s without tensor cores, dense bf16 tensor-core
# FLOP/s, dense TF32 tensor-core FLOP/s: half the bf16 rate), NVIDIA data
# sheets
CARDS = {"H100 PCIe": (2.0e12, 51e12, 756e12, 378e12),
         "H100 NVL": (3.9e12, 60e12, 835e12, 417.5e12),
         "H200": (4.8e12, 67e12, 989e12, 495e12),
         "H100": (3.35e12, 67e12, 989e12, 495e12)}
# qwen3-4b's prefill in the continuous engine: B, H, KVH, S, D
SERVE_SHAPE = (1, 32, 8, 512, 128)
# the LM evals' flash calls (float32): 8a (qwen3-4b width, batch 2, 128
# tokens) and 8b (train_lm_elastic's 100m preset, batch 16, 512 tokens)
EVAL_SHAPES = {"8a": (2, 32, 8, 128, 128), "8b": (16, 12, 3, 512, 64)}
FLASH_SWEEP = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
               (1, 4, 2, 256, 128), (1, 8, 2, 512, 64), SERVE_SHAPE,
               *EVAL_SHAPES.values()]
# phases 6e and 6v (b): K5's calls on the new families' paths, bf16 (B, H,
# KVH, S, D) and causal: seamless-m4t-large-v2's encoder (4 requests of
# 512 frames) and qwen2-vl-7b's forward (1024 patches + 128 text tokens)
FAMILY_FLASH = {"seamless encoder": ((4, 16, 16, 512, 64), False),
                "qwen2-vl forward": ((1, 28, 4, 1152, 128), True)}
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


def hgmma_count(path):
    """HGMMA (warpgroup tensor-core) instructions in a library's SASS, all
    and TF32 ones, as ``cuobjdump -sass <lib> | grep -c HGMMA`` and ``...
    | grep HGMMA | grep -c TF32`` count them."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    lines = [line for line in sass.splitlines() if "HGMMA" in line]
    return len(lines), sum("TF32" in line for line in lines)


def median_ms(torch, fn, reps: int = 30, warm: int = 5,
              flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` calls. Each timed call
    is queued behind a ~5 ms GPU sleep, so the host has enqueued it before
    the start event fires: the events bracket device work only, not the
    host's launch latency (tens of µs through Python and ctypes). With
    ``flush`` (a tensor larger than the 50 MB L2), it is zeroed before each
    timed call, so ``fn`` finds its inputs in device memory, not in L2."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        torch.cuda._sleep(10_000_000)  # GPU clock cycles
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def card_rates(name: str):
    for key, rates in CARDS.items():
        if key in name:
            return key, rates
    raise RuntimeError(f"no memory/FLOP rates on record for {name!r}")


def check_kernels(torch, rates):
    """Phase 3: every kernel against its plain version, then timed."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.kernels.adahessian import ops as ada
    from repro_torch.kernels.elastic import ops as ela
    from repro_torch.optim.adahessian import bias_corrections

    bw, flops = rates[:2]
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
    # -- K2: elastic batched exchange, stale off and on, at the paper CNN's
    #    n (rows alternately 16- and 8-byte aligned) and at an odd n (rows
    #    4-byte aligned); timed at both; K3 below reuses the path's n ----
    hw = torch.rand(2, K, generator=gen, device=dev) * 0.3
    entry = {"name": ela.BATCHED_KERNEL.name, "route": "cuda",
             "source": "src/repro_torch/csrc/elastic.cu",
             "replaces": "src/repro/kernels/elastic/kernel.py:107",
             "library_ms": None, "odd_n": N_ODD}
    for n in (N_ODD, N):
        w, mm, ref = rnd(K, n), rnd(n), rnd(n)
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
            plain_ms = median_ms(
                torch, lambda: ela.elastic_update_batched_plain(pw, pm, hw, r))
            b_ms, b_by = bound((2 * K + 2 + stale) * 4 * n + 8 * K,
                               (5 * K + 1) * n)
            tag = ("stale_" if stale else "") + ("odd_" if n == N_ODD else "")
            entry.update({f"{tag}max_abs_err": err, f"{tag}ms": ms,
                          f"{tag}plain_ms": plain_ms, f"{tag}bound_ms": b_ms})
            entry.setdefault("bound_by", b_by)
            del kw_, km_, pw, pm
    # the same bytes as one device-to-device copy of (k+1, n) floats (read
    # once, written once): what the card's memory gives a plain stream,
    # beside the byte bound; timed only
    src = torch.cat([w, mm[None]])
    dst = torch.empty_like(src)
    entry["copy_ms"] = median_ms(torch, lambda: dst.copy_(src))
    del src, dst
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
    # -- K4: one worker's AdaHessian step (the plain control), at the paper
    #    CNN's n and at an odd n; scalars from the step count on the card --
    scalars = ada.pack_scalars(OptimizerConfig(lr=0.01),
                               torch.tensor(3, device=dev))
    entry = {"name": ada.FLAT_KERNEL.name, "route": "cuda",
             "source": "src/repro_torch/csrc/adahessian.cu",
             "replaces": "src/repro/kernels/adahessian/kernel.py:59",
             "library_ms": None}
    errs = {}
    for n in (N, N_ODD):
        p, g, h, m = rnd(n), rnd(n), rnd(n), rnd(n, s=0.1)
        v = rnd(n, s=0.1).abs()
        kp, km, kv = p.clone(), m.clone(), v.clone()
        ada.adahessian_step(kp, g, h, km, kv, scalars)
        ada.adahessian_step_plain(p, g, h, m, v, scalars)
        torch.cuda.synchronize()
        for got, want in ((kp, p), (km, m), (kv, v)):
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
        errs[n] = max(max_err(kp, p), max_err(km, m), max_err(kv, v))
        if n == N:
            # its five (n,) inputs, 24 MB, fit in the 50 MB L2: timed with
            # L2 flushed before each call (against the device-memory
            # bound) and, as warm_ms, with them left in L2
            flush = torch.empty(64 << 20, device=dev)  # 256 MB
            step = lambda: ada.adahessian_step(kp, g, h, km, kv, scalars)
            ms = median_ms(torch, step, flush=flush)
            warm_ms = median_ms(torch, step)
            plain_ms = median_ms(torch, lambda: ada.adahessian_step_plain(
                p, g, h, m, v, scalars), flush=flush)
            del flush
        del p, g, h, m, v, kp, km, kv
    b_ms, b_by = bound(32 * N + 4 * 7, 17 * N)
    entry.update({"max_abs_err": errs[N], "odd_n": N_ODD,
                  "odd_max_abs_err": errs[N_ODD], "ms": ms,
                  "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                  "bound_by": b_by})
    out.append(entry)
    for e in out:
        log(f"  {e['name']}: max_abs_err {e['max_abs_err']:.3g}, kernel "
            f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']})"
            + "".join(f"; {tag[:-1]}: err {e[tag + 'max_abs_err']:.3g}, "
                      f"kernel {e[tag + 'ms']:.4f} ms, plain "
                      f"{e[tag + 'plain_ms']:.4f} ms, bound "
                      f"{e[tag + 'bound_ms']:.4f} ms"
                      for tag in ("stale_", "odd_", "stale_odd_")
                      if tag + "ms" in e))
    log(f"  adahessian_update_flat: L2 flushed before each call (plain "
        f"too); with its inputs left in L2 {warm_ms:.4f} ms; at odd "
        f"n={N_ODD}: max_abs_err {errs[N_ODD]:.3g}")
    log(f"  elastic_update_batched's bytes as one copy_: "
        f"{out[1]['copy_ms']:.4f} ms")
    log("  library_ms: none — no single PyTorch call computes any of "
        "these four functions")
    return out


def check_flash(torch, rates):
    """Phase 3b: the flash-attention kernel against its plain version over
    the CPU tests' sweep, the serving shape and the LM evals' shapes,
    float32 and bfloat16, at the reference's tolerances; then timed beside
    the plain version, the byte/operation bound, and one library call
    (``scaled_dot_product_attention``, timed only, never used by the port):
    bfloat16 at the serving shape, float32 (split TF32) there and at the 8a
    and 8b evals' shapes, bfloat16 at the MoE admits with their masks. The
    float32 bound is the split-TF32 route's (three TF32 products at the
    dense TF32 rate, or the bytes, whichever is longer), with the CUDA-core
    route's beside it."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fla

    bw, f32_rate, bf16_rate, tf32_rate = rates
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

    # each (query row, head) of the timed calls: |got - want| / |want| over D
    row_tols = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

    def timed(shape, dtype, mask=None, causal=True):
        """One call at ``shape``, causal or not, with ``mask`` (a window or
        a chunk, or none), held to plain elementwise at the tolerance above
        and each
        (query row, head) norm-wise; past S=512 one kv head (its query
        heads) at a time, as phase 7b holds blockwise attention (the full
        (H, S, S) scores of mixtral's and scout's admits would not fit
        beside each other). With a window or a chunk, plain versions with
        it one 64-key tile shorter and longer must fail the norm-wise check,
        which shows that the check sees the mask. Then timed beside the
        plain version (the same per-head loop) and SDPA with the same mask,
        and the bounds over the live (query, key) pairs."""
        B, H, KVH, S, D = shape
        G = H // KVH
        mask = mask or {}
        q, k, v = qkv(*shape, dtype)
        got = fla.flash_attention_bshd(q, k, v, causal=causal, **mask)
        parts = range(KVH) if S > 512 else [None]

        def plain(h, m=mask):
            if h is None:
                return fla.flash_attention_plain(q, k, v, causal=causal, **m)
            heads = slice(h * G, (h + 1) * G)
            return fla.flash_attention_plain(
                q[:, :, heads], k[:, :, h:h + 1], v[:, :, h:h + 1],
                causal=causal, **m)

        def held(m, strict):
            """(max abs err, worst row's norm-wise err) of ``got`` against
            plain under mask ``m``; elementwise-asserted when ``strict``."""
            worst = rel = 0.0
            for h in parts:
                want = plain(h, m).float()
                part = (got if h is None
                        else got[:, :, h * G:(h + 1) * G]).float()
                if strict:
                    torch.testing.assert_close(part, want, rtol=tols[dtype],
                                               atol=tols[dtype])
                worst = max(worst, float((part - want).abs().max()))
                rel = max(rel, float(((part - want).norm(dim=-1)
                                      / want.norm(dim=-1)).max()))
                del want, part
            return worst, rel

        out = {}
        out["max_abs_err"], out["max_row_rel_err"] = held(mask, True)
        row_tol = row_tols[dtype]
        if out["max_row_rel_err"] > row_tol:
            raise AssertionError(
                f"flash at {shape} {mask}: a (row, head) off plain by "
                f"{out['max_row_rel_err']:.3g} of its norm > {row_tol}")
        shifted = {}
        for key in ("window", "chunk"):
            for step in ((-64, 64) if key in mask else ()):
                name = f"{key} {mask[key] + step}"
                shifted[name] = held({**mask, key: mask[key] + step},
                                     False)[1]
                if shifted[name] <= row_tol:
                    raise AssertionError(
                        f"flash at {shape} {mask}: plain with {name} passes "
                        f"the norm-wise check ({shifted[name]:.3g})")
        if shifted:
            out["shifted_plain_row_rel_err"] = shifted
        reps = 30 if S <= 512 else 10
        out["ms"] = median_ms(torch, lambda: fla.flash_attention_bshd(
            q, k, v, causal=causal, **mask), reps=reps)
        out["plain_ms"] = median_ms(
            torch, lambda: [plain(h) for h in parts],
            reps=reps if S <= 512 else 3, warm=5 if S <= 512 else 1)
        pos = torch.arange(S, device=dev)
        live = ((pos[None, :] <= pos[:, None]) if causal
                else torch.ones(S, S, dtype=torch.bool, device=dev))
        if "window" in mask:
            live &= (pos[:, None] - pos[None, :]) < mask["window"]
        if "chunk" in mask:
            live &= (pos[:, None] // mask["chunk"]) == (
                pos[None, :] // mask["chunk"])
        qt = q.transpose(1, 2)
        if mask:  # the masked SDPA takes no gqa: k and v widened to H
            kt, vt = (x.transpose(1, 2).repeat_interleave(G, 1)
                      for x in (k, v))
            kw = dict(attn_mask=live)
        else:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            kw = dict(is_causal=causal, enable_gqa=True)
        out["library_ms"] = median_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
            reps=reps)
        lib_err = ("" if S > 512 else "; sdpa vs plain " + format(float((
            F.scaled_dot_product_attention(qt, kt, vt, **kw).transpose(1, 2)
            .float() - plain(None).float()).abs().max()), ".3g"))
        out["live_pairs"] = pairs = int(live.sum())  # of one head
        nbytes = (2 * B * S * H * D + 2 * B * S * KVH * D) * q.element_size()
        nops = 4 * D * pairs * B * H
        b_ms = nbytes / bw * 1e3

        def bound(o_ms):
            return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

        if dtype == torch.bfloat16:
            out["bound_ms"], out["bound_by"] = bound(nops / bf16_rate * 1e3)
        else:  # the route taken: three TF32 products; the CUDA cores' beside
            out["bound_ms"], out["bound_by"] = bound(
                3 * nops / tf32_rate * 1e3)
            out["cuda_core_bound_ms"] = bound(nops / f32_rate * 1e3)[0]
        out["pct_of_bound"] = 100 * out["bound_ms"] / out["ms"]
        log(f"  flash_attention_fwd {str(dtype).removeprefix('torch.')} at "
            f"B,H,KVH,S,D={shape} {'causal' if causal else 'non-causal'}"
            f"{f' {mask}' if mask else ''}: max_abs_err "
            f"{out['max_abs_err']:.3g}, worst (row, head) "
            f"{out['max_row_rel_err']:.3g} of its norm (tol {row_tol}"
            + "".join(f"; plain with {name}: {err:.3g}"
                      for name, err in shifted.items())
            + f"{lib_err}){' per kv head' if S > 512 else ''}; kernel "
            f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, sdpa "
            f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']}: {nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} "
            f"GFLOP over {pairs:,} live pairs a head; "
            f"{out['pct_of_bound']:.0f}% of it)"
            + (f", CUDA-core bound {out['cuda_core_bound_ms']:.4f} ms"
               if "cuda_core_bound_ms" in out else ""))
        del q, k, v, got, qt, kt, vt, live
        torch.cuda.empty_cache()
        return out

    B, H, KVH, S, D = SERVE_SHAPE
    entry = {"name": fla.KERNEL.name, "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:97",
             "shape_bshd": [B, S, H, KVH, D], "sweep_max_abs_err": sweep_err}
    entry.update(timed(SERVE_SHAPE, torch.bfloat16))
    entry.update({f"f32_{key}": val for key, val in
                  timed(SERVE_SHAPE, torch.float32).items()})
    for phase, shape in EVAL_SHAPES.items():
        B, H, KVH, S, D = shape
        entry[f"f32_eval_{phase}"] = {"shape_bshd": [B, S, H, KVH, D],
                                      **timed(shape, torch.float32)}
    entry["moe_admits"] = {}
    for arch in MOE_SERVE:
        shape, mask = moe_admit(arch)
        B, H, KVH, S, D = shape
        entry["moe_admits"][arch] = {"shape_bshd": [B, S, H, KVH, D],
                                     "mask": mask,
                                     **timed(shape, torch.bfloat16, mask)}
    entry["family_calls"] = {}
    for name, (shape, causal) in FAMILY_FLASH.items():
        B, H, KVH, S, D = shape
        entry["family_calls"][name] = {
            "shape_bshd": [B, S, H, KVH, D], "causal": causal,
            **timed(shape, torch.bfloat16, causal=causal)}
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
                "adahessian_update_flat": 0,
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


def _leaf_parity(torch, layout, got, want, what, norm_tol):
    """Per-leaf agreement of two flat float64 buffers: elementwise rtol 1e-4
    with an atol of 2% of the leaf's scale (a max-pool window whose two
    largest conv outputs are within a few ulps can pick a different winner
    on the two devices; tests/test_torch_session.py measures it), and
    norm-wise within ``norm_tol``. Returns (worst norm-wise, worst abs)."""
    worst_norm, worst_abs = 0.0, 0.0
    for leaf in layout.leaves:
        sl = slice(leaf.offset, leaf.offset + leaf.size)
        g, w = got[sl], want[sl]
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=2e-2 * float(w.abs().max()))
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        if rel > norm_tol:
            raise AssertionError(f"{what} {leaf.name}: cuda vs cpu norm-wise "
                                 f"{rel:.2e} > {norm_tol:g}")
        worst_norm = max(worst_norm, rel)
        worst_abs = max(worst_abs, float((g - w).abs().max()))
    return worst_norm, worst_abs


def train_cli(torch):
    """Phase 5b: the training CLI on the card at the paper's full width
    (PaperCNN, 1,199,882 parameters, the CLI's 8000 synthetic images),
    through ``repro_torch.launch.train.main`` as a user calls it. Each
    run's kernel launches are counted from 0 and must be exactly what its
    path calls. Returns (the ``train_cli`` record, the plain run's
    launches)."""
    import dataclasses
    import math

    import numpy as np

    from repro_torch.api.session import ElasticSession
    from repro_torch.checkpoint import checkpoint
    from repro_torch.kernels import kernels, reset_launch_counts
    from repro_torch.launch.train import main
    from repro_torch.nn.param import tree_leaves

    def run(label, argv, want):
        reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            sess, recs = main(argv)
        moved = {n: x.launches for n, x in kernels().items()}
        full = {n: want.get(n, 0) for n in moved}
        if moved != full:
            raise AssertionError(f"{label}: launches {moved}, expected "
                                 f"{full}")
        if not bool(torch.isfinite(sess.master_params).all()):
            raise AssertionError(f"{label}: non-finite master params")
        last = [line for line in buf.getvalue().splitlines()
                if line.startswith(("round ", "step "))][-1]
        steady = statistics.median(r.round_ms for r in recs[1:])
        log(f"  {label}: {len(recs)} rounds, median round ms {steady:.2f} "
            f"(first {recs[0].round_ms:.1f}), launches "
            f"{ {n: c for n, c in moved.items() if c} }")
        log(f"    last: {last[:240]}")
        return sess, recs, {"rounds": len(recs), "round_ms": steady,
                            "first_round_ms": recs[0].round_ms,
                            "final_loss": recs[-1].loss,
                            "launches": moved}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "deahes_o")
        # (a) DEAHES-O defaults at k=8, τ=4, sequential comm, with --save
        sess, recs, rec = run(
            "DEAHES-O k=8 tau=4 --save",
            ["--workers", "8", "--tau", "4", "--rounds", "8", "--save", ck],
            {"adahessian_update_batched": 32, "elastic_update": 64})
        if not all(math.isfinite(r.loss) for r in recs):
            raise AssertionError("DEAHES-O: a non-finite loss")
        master = sess.master_params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back, meta = checkpoint.restore(ck, like=sess.master_tree())
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        leaves = dict(tree_leaves(back))
        flat = torch.cat([leaves[leaf.path].reshape(-1)
                          for leaf in sess.layout.leaves])
        if not torch.equal(flat, master) or meta["rounds"] != 8:
            raise AssertionError("checkpoint.restore did not read back the "
                                 "saved master bit for bit")
        t0 = time.perf_counter()
        sess.save(os.path.join(tmp, "again"))
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(os.path.getsize(os.path.join(ck, f))
                     for f in os.listdir(ck))
        warm = ElasticSession(dataclasses.replace(sess.spec, rounds=2,
                                                  save_path=None))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm.restore(ck)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(warm.state["master"], master) and torch.equal(
                warm.state["u_hist"], sess.state["u_hist"])):
            raise AssertionError("warm start: master or u-history differ")
        reset_launch_counts()
        warm_recs = warm.run()
        warm_launches = {n: x.launches for n, x in kernels().items()}
        if (warm_launches["adahessian_update_batched"] != 8
                or warm_launches["elastic_update"] != 16
                or not all(math.isfinite(r.loss) for r in warm_recs)):
            raise AssertionError(f"warm start: launches {warm_launches}, "
                                 f"losses {[r.loss for r in warm_recs]}")
        out["deahes_o"] = rec
        out["checkpoint"] = {
            "bytes": nbytes, "files": len(os.listdir(ck)),
            "save_ms": save_ms, "restore_ms": restore_ms,
            "session_restore_ms": warm_ms, "bitwise": True,
            "warm_start_losses": [r.loss for r in warm_recs]}
        log(f"  checkpoint: {nbytes} bytes in {len(os.listdir(ck))} files, "
            f"save {save_ms:.2f} ms, restore {restore_ms:.2f} ms (bit for "
            f"bit), session warm start {warm_ms:.2f} ms, then 2 rounds: "
            f"losses {[round(r.loss, 4) for r in warm_recs]}")
        del sess, warm
    # (b) the plain control: 50 single-worker steps, all through kernel 1
    sess, recs, rec = run("plain x50", ["--plain", "--rounds", "50"],
                          {"adahessian_update_flat": 50})
    if not all(math.isfinite(r.loss) for r in recs):
        raise AssertionError("plain: a non-finite loss")
    rec["step_ms"] = rec.pop("round_ms")
    batch = {key: val[0, 0] for key, val in
             sess._to_device(sess.batcher.round_batches()).items()}
    rec["profile"] = profile_window(
        torch, "plain step (profiled)",
        lambda: sess._step(sess.state, batch, sess.round), 3)
    out["plain"] = rec
    plain_launches = rec["launches"]
    # (c) the adversarial channels and the distance clamp. The byzantine
    #    runs record, per round, the live corrupt slots refused (h2 = 0)
    #    and the live honest slots accepted (h2 > 0). Rounds 0-2 score
    #    every slot above 4 (the u-history is still filling), so both clips
    #    refuse all of them. In round 3 the honest slots score 3.04-3.21 and
    #    the corrupt ones 4.74-4.77: --score-clip 3 still refuses everyone,
    #    --score-clip 4 must accept every live honest slot and refuse both
    #    corrupt ones.
    byz = ["--failure-scenario", "byzantine", "--byzantine-mode", "noise"]
    runs = {
        "byzantine": (4, byz + ["--score-clip", "3"]),
        "byzantine_clip4": (4, byz + ["--score-clip", "4"]),
        "hetero": (4, ["--failure-scenario", "hetero"]),
        "u_zclip": (4, ["--u-zclip", "3", "--comm-mode", "fused"])}
    for label, (rounds, extra) in runs.items():
        want = {"adahessian_update_batched": 4 * rounds}
        if label == "u_zclip":
            want["elastic_update_batched"] = rounds
        else:
            want["elastic_update"] = 8 * rounds
        sess, recs, rec = run(f"{label} k=8 tau=4", [
            "--workers", "8", "--tau", "4", "--rounds", str(rounds)] + extra,
            want)
        if label.startswith("byzantine"):
            bad = sess.schedule.corrupt[0]
            honest = [r.loss_w[~bad] for r in recs]
            if not bad.any() or not all(np.isfinite(x).all()
                                        for x in honest):
                raise AssertionError("byzantine: no corrupt slot, or a "
                                     "non-finite honest loss")
            rec["corrupt_slots"] = np.flatnonzero(bad).tolist()
            live_bad = [bad & ~r.fail for r in recs]
            rec["refused_rounds"] = [
                int(((r.h2 == 0) & lb).sum()) for r, lb in zip(recs, live_bad)]
            rec["corrupt_live_rounds"] = [int(lb.sum()) for lb in live_bad]
            rec["honest_accepted_rounds"] = [
                int(((r.h2 > 0) & ~bad & ~r.fail).sum()) for r in recs]
            rec["honest_live_rounds"] = [
                int((~bad & ~r.fail).sum()) for r in recs]
            log(f"    corrupt slots {rec['corrupt_slots']}: refused "
                f"{rec['refused_rounds']} of live {rec['corrupt_live_rounds']}"
                f"; honest accepted {rec['honest_accepted_rounds']} of live "
                f"{rec['honest_live_rounds']}")
            if rec["refused_rounds"] != rec["corrupt_live_rounds"]:
                raise AssertionError(f"{label}: a live corrupt slot's pull "
                                     "was accepted")
            if label == "byzantine_clip4" and (
                    rec["honest_accepted_rounds"][3]
                    != rec["honest_live_rounds"][3]):
                raise AssertionError(f"{label}: a live honest slot was "
                                     "refused in round 3")
        else:
            if not all(math.isfinite(r.loss) for r in recs):
                raise AssertionError(f"{label}: a non-finite loss")
        if label == "hetero":
            if not sess.schedule.has_hetero:
                raise AssertionError("hetero: every slot at full speed")
            rec["speeds"] = sess.schedule.speed[0].tolist()
        out[label] = rec
    return out, plain_launches


def plain_device_parity(torch):
    """Phase 5c: the plain control on the card (single-worker kernel) and
    on the CPU (its plain version) from the same carried params and
    probes, three steps; params agree per leaf (elementwise rtol 1e-4,
    atol 2% of the leaf's scale; norm-wise 1e-3, the ROADMAP's state
    tolerance), and so do the losses (rtol 1e-4)."""
    import numpy as np

    from repro_torch.api.session import ElasticSession, RunSpec
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flatten import FlatLayout
    from repro_torch.models.cnn import PaperCNN
    from repro_torch.nn.param import init_tree

    spec_tree = PaperCNN(get_config("paper-cnn")).spec
    layout = FlatLayout(spec_tree)
    params = init_tree(torch.Generator().manual_seed(4), spec_tree)

    def probes(device):
        def fn(r, t, i):
            rng = np.random.default_rng([12, r, t, i])
            z = rng.integers(0, 2, (1, layout.n)).astype(np.float32) * 2 - 1
            return torch.from_numpy(z).to(device)
        return fn

    got = {}
    for device in ("cuda", "cpu"):
        sess = ElasticSession(RunSpec(plain=True, rounds=3, batch_size=32,
                                      n_data=2000, n_test=100,
                                      device=device),
                              params=params, probe_fn=probes(device))
        losses = [r.loss for r in sess.run()]
        got[device] = (sess.state["params"].cpu().double(), losses)
    worst_norm, worst_abs = _leaf_parity(torch, layout, got["cuda"][0],
                                         got["cpu"][0], "plain", 1e-3)
    np.testing.assert_allclose(got["cuda"][1], got["cpu"][1], rtol=1e-4)
    log(f"  plain x3: cuda vs cpu params max abs err {worst_abs:.3g}, worst "
        f"leaf norm-wise {worst_norm:.3g}; losses cuda {got['cuda'][1]} cpu "
        f"{got['cpu'][1]}")
    return {"max_abs_err": worst_abs, "worst_leaf_norm_rel": worst_norm}


class MembershipWatch:
    """Checks the membership contract on every ``ElasticTrainer`` round
    while installed: a slot vacant in a round leaves it with its
    parameters bit-unchanged (unless a crash-restart drawn for it re-seats
    it from the master, as in the reference), and every slot a round
    re-seats (a join or a restart) equals the master when its local phase
    starts. Counts what it checked; raises at the first breach."""

    def __init__(self, torch):
        from repro_torch.core.coordinator import ElasticTrainer

        self.torch, self.cls = torch, ElasticTrainer
        self.vacant_checks = self.reseat_checks = self.vacant_reseats = 0

    def __enter__(self):
        import numpy as np

        torch, watch = self.torch, self
        round_step, apply_restarts = (self.cls.round_step,
                                      self.cls.apply_restarts)

        def checked_round(trainer, state, inputs):
            vacant = (None if inputs.active is None
                      else torch.as_tensor(~inputs.active))
            if vacant is not None and inputs.restart is not None:
                watch.vacant_reseats += int((~inputs.active
                                             & inputs.restart).sum())
                vacant &= torch.as_tensor(~inputs.restart)
            before = (None if vacant is None or not vacant.any()
                      else state["workers"][vacant.to(state["workers"]
                                                      .device)].clone())
            out = round_step(trainer, state, inputs)
            if before is not None:
                after = state["workers"][vacant.to(before.device)]
                if not torch.equal(after, before):
                    raise AssertionError(f"round {inputs.round}: a vacant "
                                         "slot's parameters moved")
                watch.vacant_checks += int(vacant.sum())
            return out

        def checked_reseat(trainer, state, reseat):
            apply_restarts(trainer, state, reseat)
            rows = np.flatnonzero(reseat)
            for i in rows:
                if not torch.equal(state["workers"][i], state["master"]):
                    raise AssertionError(f"slot {i} re-seated off the master")
            watch.reseat_checks += len(rows)

        self.saved = (round_step, apply_restarts)
        self.cls.round_step = checked_round
        self.cls.apply_restarts = checked_reseat
        return self

    def __exit__(self, *exc):
        self.cls.round_step, self.cls.apply_restarts = self.saved
        return False


def _cli_run(torch, label, argv, want):
    """``launch/train.py``'s ``main`` on ``argv`` under a
    :class:`MembershipWatch`, every launch count zeroed just before and
    read just after: they must be ``want`` (0 for the others). Returns
    (session, records, watch, captured stdout)."""
    from repro_torch.kernels import kernels, reset_launch_counts
    from repro_torch.launch.train import main

    buf = io.StringIO()
    with MembershipWatch(torch) as watch:
        reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            sess, recs = main(argv)
        moved = {n: x.launches for n, x in kernels().items()}
    full = {n: want.get(n, 0) for n in moved}
    if moved != full:
        raise AssertionError(f"{label}: launches {moved}, expected {full}")
    if not bool(torch.isfinite(sess.master_params).all()):
        raise AssertionError(f"{label}: non-finite master params")
    for rec in recs:
        vac = ~rec.active
        if any(getattr(rec, key)[vac].any()
               for key in ("u", "score", "h1", "h2", "loss_w")):
            raise AssertionError(f"{label} round {rec.round}: a vacant "
                                 "slot's record is not zero")
    log(f"  {label}: live per round {[r.num_active for r in recs]}, "
        f"launches { {n: c for n, c in moved.items() if c} }, vacant rows "
        f"checked frozen {watch.vacant_checks}, re-seats checked "
        f"{watch.reseat_checks}")
    return sess, recs, watch, buf.getvalue(), moved


def membership_cli(torch):
    """Phase 5d: membership on the card through ``launch/train.py``'s
    ``main`` at PaperCNN's full width. DEAHES-O, τ=4, 8 rounds: 4 live
    slots of 8 scaled up to 8 at round 3, in both comm modes; then a
    preempt_rejoin run (slots 6 and 7 out for rounds 3-5). Each run's
    kernel launches are exactly its path's: the batched AdaHessian step
    once per τ-step over all 8 rows, and the exchange over all 8 slots
    (vacant ones with zero weights) in either comm mode."""
    out = {}
    base = ["--tau", "4", "--rounds", "8", "--capacity", "8"]
    runs = {
        "scale_up_sequential": (["--workers", "4", "--membership-scenario",
                                 "scale_up", "--membership-k", "8",
                                 "--membership-round", "3"], "sequential",
                                [4, 4, 4, 8, 8, 8, 8, 8]),
        "scale_up_fused": (["--workers", "4", "--membership-scenario",
                            "scale_up", "--membership-k", "8",
                            "--membership-round", "3"], "fused",
                           [4, 4, 4, 8, 8, 8, 8, 8]),
        "preempt_rejoin": (["--workers", "8", "--membership-scenario",
                            "preempt_rejoin", "--membership-k", "2",
                            "--membership-round", "3"], "sequential",
                           [8, 8, 8, 6, 6, 6, 8, 8]),
    }
    for label, (flags, comm, live) in runs.items():
        want = {"adahessian_update_batched": 8 * 4}
        want["elastic_update" if comm == "sequential"
             else "elastic_update_batched"] = 8 * (8 if comm ==
                                                   "sequential" else 1)
        sess, recs, watch, _, moved = _cli_run(
            torch, label, base + flags + ["--comm-mode", comm], want)
        if [r.num_active for r in recs] != live:
            raise AssertionError(f"{label}: live per round "
                                 f"{[r.num_active for r in recs]}")
        joins = sum(int(x.sum()) for x in sess.schedule.joins())
        if watch.reseat_checks != joins or not watch.vacant_checks:
            raise AssertionError(f"{label}: {watch.reseat_checks} re-seats "
                                 f"checked of {joins} joins")
        ms = [r.round_ms for r in recs]
        entry = {"live": live, "launches": moved,
                 "vacant_rows_checked": watch.vacant_checks,
                 "joins_checked": watch.reseat_checks,
                 "final_loss": recs[-1].loss, "round_ms": ms}
        if label.startswith("scale_up"):
            # round 0 carries warm-up; round 3 the joins
            entry["round_ms_4_of_8_live"] = statistics.median(ms[1:3])
            entry["round_ms_8_of_8_live"] = statistics.median(ms[4:])
            log(f"    round ms at capacity 8: 4 live "
                f"{entry['round_ms_4_of_8_live']:.2f}, 8 live "
                f"{entry['round_ms_8_of_8_live']:.2f}")
            entry["profile"] = profile_live_counts(torch, sess.spec)
        out[label] = entry
    return out


def profile_live_counts(torch, spec):
    """Where a capacity-8 round's time goes with 4 and with 8 live slots:
    a fresh session of ``spec`` (the scale-up run's), one profiled round
    at 4 live (round 1, after a warm-up round) and one at 8 live (round 5,
    after the joins and a warm-up round)."""
    import dataclasses

    from repro_torch.api.session import ElasticSession

    sess = ElasticSession(dataclasses.replace(spec, save_path=None))
    out = {"4_of_8_live": profile_window(
        torch, "round at 4 of 8 live (profiled)",
        lambda: sess._run_chunk(1), 1)}
    sess.run(2)
    out["8_of_8_live"] = profile_window(
        torch, "round at 8 of 8 live (profiled)",
        lambda: sess._run_chunk(1), 1)
    return out


def control_cli(torch):
    """Phase 5e: closed-loop control on the card: ``--controller rules``
    under crash_restart at k=8 (capacity 8), 12 rounds, open and
    ``--detector-blind``. The journal of applied actions is printed; the
    live mask of the round after each applied action is what the action
    says, and an evicted slot's parameters stay bit-unchanged while it is
    out (``MembershipWatch``). No closed-loop precision or recall is
    asserted."""
    out = {}
    argv = ["--workers", "8", "--capacity", "8", "--rounds", "12",
            "--controller", "rules", "--failure-scenario", "crash_restart"]
    for label, extra in (("rules", []),
                         ("rules_detector_blind", ["--detector-blind"])):
        sess, recs, watch, text, moved = _cli_run(
            torch, label, argv + extra,
            {"adahessian_update_batched": 12, "elastic_update": 12 * 8})
        journal = [line for line in text.splitlines()
                   if line.startswith("[control]")]
        for line in journal:
            log(f"    {line}")
        applied = [a for a in sess.controller.actuator.log if a.applied]
        for a in applied:
            if a.action.kind not in ("evict", "readmit"):
                continue
            row = recs[a.round].active if a.round < len(recs) else None
            want = a.action.kind == "readmit"
            if row is None or any(row[s] != want for s in a.action.slots):
                raise AssertionError(f"{label}: round {a.round} live mask "
                                     f"{row} after {a.action.describe()}")
        if extra and any(r.fail.any() or r.restart.any() for r in recs):
            raise AssertionError("detector-blind records carry truth")
        out[label] = {
            "journal_length": len(sess.controller.actuator.log),
            "applied": [{"round": a.round, "action": a.action.describe(),
                         "live_after": a.live_after} for a in applied],
            "live": [r.num_active for r in recs], "launches": moved,
            "vacant_rows_checked": watch.vacant_checks,
            "vacant_reseated_by_restart": watch.vacant_reseats,
            "round_ms": statistics.median(r.round_ms for r in recs[1:])}
    return out


def membership_device_parity(torch):
    """Phase 5f: membership on the card (kernels) and on the CPU (plain
    versions), 4 rounds of DEAHES-O at capacity 6 with 4 live slots scaled
    up to 6 at round 2, from the same carried params and probes; the
    masters agree at phase 5's tolerance (``_leaf_parity``, norm-wise
    1e-4)."""
    import numpy as np

    from repro_torch.api.session import ElasticSession, RunSpec
    from repro_torch.configs.base import (ElasticConfig, OptimizerConfig,
                                          get_config)
    from repro_torch.kernels.flatten import FlatLayout
    from repro_torch.models.cnn import PaperCNN
    from repro_torch.nn.param import init_tree

    spec_tree = PaperCNN(get_config("paper-cnn")).spec
    layout = FlatLayout(spec_tree)
    params = init_tree(torch.Generator().manual_seed(5), spec_tree)

    def probes(device):
        def fn(r, t, i):
            rng = np.random.default_rng([13, r, t, i])
            z = rng.integers(0, 2, (1, layout.n)).astype(np.float32) * 2 - 1
            return torch.from_numpy(z).to(device)
        return fn

    masters, live = {}, {}
    for device in ("cuda", "cpu"):
        spec = RunSpec(
            optimizer=OptimizerConfig(name="adahessian"),
            elastic=ElasticConfig(num_workers=4, capacity=6, tau=1,
                                  membership_scenario="scale_up",
                                  membership_k=6, membership_round=2),
            rounds=4, batch_size=32, n_data=2000, n_test=100, device=device)
        sess = ElasticSession(spec, params=params, probe_fn=probes(device))
        live[device] = [r.num_active for r in sess.run()]
        masters[device] = sess.state["master"].cpu().double()
    if not live["cuda"] == live["cpu"] == [4, 4, 6, 6]:
        raise AssertionError(f"live per round {live}")
    worst_norm, worst_abs = _leaf_parity(torch, layout, masters["cuda"],
                                         masters["cpu"], "membership", 1e-4)
    log(f"  scale-up 4 -> 6 of 6: cuda vs cpu master max abs err "
        f"{worst_abs:.3g}, worst leaf norm-wise {worst_norm:.3g}")
    return {"max_abs_err": worst_abs, "worst_leaf_norm_rel": worst_norm}


def grid_report(torch):
    """Phase 5g: two §VI grid jobs (DEAHES-O and EASGD, k=4, τ=1, 4
    rounds) through ``experiments/grid.py``'s ``run_pool``, each a
    ``paper_repro`` process on the card, then ``experiments/report.py``'s
    ``repro_tables`` on their JSON."""
    from repro_torch.experiments import grid, report

    with tempfile.TemporaryDirectory() as tmp:
        jobs = grid.grid_jobs(rounds=4, methods=["DEAHES-O", "EASGD"],
                              ks=(4,), taus=(1,), device="cuda",
                              results=os.path.join(tmp, "paper_repro"))
        if len(jobs) != 2 or any(cmd[-2:] != ["--device", "cuda"]
                                 for _, cmd in jobs):
            raise AssertionError(f"grid jobs {jobs}")
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            failed = grid.run_pool(jobs, max_procs=2)
        wall = time.perf_counter() - t0
        if failed:
            raise AssertionError(f"grid jobs failed: {failed}")
        runs = {}
        for name in os.listdir(os.path.join(tmp, "paper_repro")):
            with open(os.path.join(tmp, "paper_repro", name)) as f:
                res = json.load(f)
            if res["device"] != "cuda:0" and res["device"] != "cuda":
                raise AssertionError(f"{name} ran on {res['device']}")
            runs[res["method"]] = {"final_acc": res["final_acc"],
                                   "round_ms": res["round_ms"]}
        table = report.repro_tables(tmp)
    row = [line for line in table.splitlines() if line.startswith("| 4 | 1 |")]
    if len(row) != 1 or row[0].count("—") != 4:
        raise AssertionError(f"report table:\n{table}")
    for line in table.strip().splitlines():
        log(f"    {line}")
    log(f"  2 jobs in {wall:.1f} s wall")
    return {"jobs": 2, "wall_s": wall, "runs": runs, "table_row": row[0]}


class RackWatch:
    """Checks the hierarchy's dark-rack contract on every hierarchical
    ``ElasticTrainer`` round while installed: a rack none of whose members
    syncs in a round (every one failed or vacant) leaves the round with
    its sub-master bit-unchanged, and on a global-sync round reports
    g_h1 = g_h2 = 0. Records (round, dark racks, sync) of each such round;
    raises at the first breach."""

    def __init__(self, torch):
        from repro_torch.core.coordinator import ElasticTrainer

        self.torch, self.cls = torch, ElasticTrainer
        self.dark = []

    def __enter__(self):
        import numpy as np

        torch, watch = self.torch, self
        round_step = self.cls.round_step

        def checked_round(trainer, state, inputs):
            if not trainer._hier:
                return round_step(trainer, state, inputs)
            dead = inputs.fail if inputs.active is None else (
                inputs.fail | ~inputs.active)
            G = trainer._n_groups
            dark = np.bincount(trainer._grp, weights=~dead, minlength=G) == 0
            sync = (state["round"] + 1) % trainer.ecfg.global_period == 0
            rows = torch.as_tensor(np.flatnonzero(dark),
                                   device=state["submasters"].device)
            before = state["submasters"][rows].clone()
            out = round_step(trainer, state, inputs)
            if not dark.any():
                return out
            metrics = out[1]
            if not torch.equal(state["submasters"][rows], before):
                raise AssertionError(f"round {inputs.round}: a dark rack's "
                                     "sub-master moved")
            if sync and (metrics["g_h1"][rows].any()
                         or metrics["g_h2"][rows].any()):
                raise AssertionError(f"round {inputs.round}: a dark rack "
                                     "was weighted at the global sync")
            watch.dark.append((inputs.round, np.flatnonzero(dark).tolist(),
                               bool(sync)))
            return out

        self.saved = round_step
        self.cls.round_step = checked_round
        return self

    def __exit__(self, *exc):
        self.cls.round_step = self.saved
        return False


def hierarchy_cli(torch):
    """Phase 5h: hierarchical averaging on the card through
    ``launch/train.py``'s ``main`` at PaperCNN's full width: DEAHES-O,
    fused comm, τ=4, 8 rounds, 16 slots in 4 racks of 4 with a global
    sync every 2 rounds (K1 once per τ-step over all 16 rows, K2 once per
    rack per round and once per global sync: 32 and 36), beside the flat
    fused k=16 run of the same flags (K2 once per round), in turns flat,
    hierarchical, hierarchical, flat; a correlated-failure run (scenario
    seed 7, the CLI's default ``--seed 0`` + 7, whose rack outages darken
    racks 2-3 at the sync after round 1, racks 0-1 after round 3 and all
    four after round 5) under :class:`RackWatch`; the first hierarchical
    run's ``--save`` read back (sub-masters bit for bit) and warm-started
    at 2 racks; card against CPU at capacity 7 in racks of 3/2/2."""
    import dataclasses
    import math

    from repro_torch.api.session import ElasticSession
    from repro_torch.checkpoint import checkpoint
    from repro_torch.kernels import kernels, reset_launch_counts

    base = ["--workers", "16", "--tau", "4", "--rounds", "8",
            "--comm-mode", "fused"]
    hier = ["--groups", "4", "--global-period", "2"]
    want_hier = {"adahessian_update_batched": 32,
                 "elastic_update_batched": 8 * 4 + 4}
    want_flat = {"adahessian_update_batched": 32,
                 "elastic_update_batched": 8}
    out, steady, specs = {}, {"flat": [], "hier": []}, {}
    with tempfile.TemporaryDirectory() as tmp, RackWatch(torch) as watch:
        ck = os.path.join(tmp, "hier")
        for i, kind in enumerate(("flat", "hier", "hier", "flat")):
            argv = base + (hier if kind == "hier" else [])
            if i == 1:
                argv = argv + ["--save", ck]
            sess, recs, _, text, moved = _cli_run(
                torch, f"{kind} k=16 tau=4 ({i + 1} of 4)", argv,
                want_hier if kind == "hier" else want_flat)
            if not all(math.isfinite(r.loss) for r in recs):
                raise AssertionError(f"{kind}: a non-finite loss")
            steady[kind].append(statistics.median(r.round_ms
                                                  for r in recs[1:]))
            specs[kind] = sess.spec
            if kind == "hier":
                syncs = [bool(r.g_h2.any()) for r in recs]
                if syncs != [r % 2 == 1 for r in range(8)]:
                    raise AssertionError(f"hier: g_h2 non-zero on rounds "
                                         f"{syncs}, not every second")
                if "g_h2=" not in text:
                    raise AssertionError("hier: no g_h2 on the round lines")
                out["launches"] = moved
                if i == 1:
                    saved_subs = sess.state["submasters"].clone()
                    saved_master = sess.state["master"].clone()
                    hier_sess = sess
        ratio = statistics.median(steady["hier"]) / statistics.median(
            steady["flat"])
        log(f"    round ms, flat / hier / hier / flat: {steady['flat'][0]:.2f}"
            f" / {steady['hier'][0]:.2f} / {steady['hier'][1]:.2f} / "
            f"{steady['flat'][1]:.2f}; hier over flat {ratio:.3f}")
        # where a round's time goes: fresh sessions of both runs' specs,
        # rounds 1 (a global sync) and 2 profiled after a warm-up round
        out["profile"] = {}
        for kind in ("flat", "hier"):
            prof = ElasticSession(dataclasses.replace(specs[kind],
                                                      save_path=None))
            out["profile"][kind] = profile_window(
                torch, f"{kind} k=16 rounds 1-2 (profiled)",
                lambda: prof._run_chunk(1), 2)
            del prof
        # the checkpoint: sub-masters beside the master, read back bit for
        # bit, then a warm start at 2 racks (racks 0-1 carried across)
        back, _ = checkpoint.restore(os.path.join(ck, "submasters"))
        got = hier_sess.layout.pack_tree(back, (4,), saved_subs.device)
        if not torch.equal(got, saved_subs):
            raise AssertionError("checkpoint: sub-masters not read back "
                                 "bit for bit")
        spec = hier_sess.spec
        warm = ElasticSession(dataclasses.replace(
            spec, rounds=2, save_path=None,
            elastic=dataclasses.replace(spec.elastic, groups=2)))
        meta = warm.restore(ck)
        if not (torch.equal(warm.state["master"], saved_master)
                and torch.equal(warm.state["submasters"], saved_subs[:2])
                and meta["elastic"]["groups"] == 4):
            raise AssertionError("warm start at 2 racks: master or "
                                 "sub-masters differ from the saved ones")
        reset_launch_counts()
        warm_recs = warm.run()
        warm_moved = {n: x.launches for n, x in kernels().items()
                      if x.launches}
        if warm_moved != {"adahessian_update_batched": 8,
                          "elastic_update_batched": 2 * 2 + 1} or not all(
                math.isfinite(r.loss) for r in warm_recs):
            raise AssertionError(f"warm start: launches {warm_moved}, "
                                 f"losses {[r.loss for r in warm_recs]}")
        log(f"  checkpoint: 4 sub-masters read back bit for bit; warm start "
            f"at 2 racks, 2 rounds: launches {warm_moved}, losses "
            f"{[round(r.loss, 4) for r in warm_recs]}")
        del hier_sess, warm, sess
        # a correlated outage at a global sync
        n_dark = len(watch.dark)
        sess, recs, _, _, moved = _cli_run(
            torch, "correlated k=16 tau=4", base + hier + [
                "--failure-scenario", "correlated"], want_hier)
        dark = watch.dark[n_dark:]
        dark_syncs = [(r, racks) for r, racks, sync in dark if sync]
        if not dark_syncs:
            raise AssertionError("correlated: no global sync with a dark "
                                 f"rack (dark rounds {dark})")
        log(f"    dark racks at global syncs (round, racks): {dark_syncs}; "
            "each refused (g_h1 = g_h2 = 0), its sub-master bit-unchanged")
    out["rack_exchange"] = time_rack_exchange(torch)
    out.update({
        "config": {"workers": 16, "groups": 4, "global_period": 2, "tau": 4,
                   "rounds": 8, "comm_mode": "fused"},
        "round_ms": {"flat": steady["flat"], "hier": steady["hier"]},
        "round_ms_hier_over_flat": ratio,
        "warm_start_groups_2": {"launches": warm_moved,
                                "losses": [r.loss for r in warm_recs]},
        "correlated": {"scenario_seed": 7, "dark_syncs": dark_syncs,
                       "launches": moved}})
    out["card_vs_cpu"] = hierarchy_device_parity(torch)
    return out


def time_rack_exchange(torch):
    """The rack exchange at the 5h run's shapes, device time
    (``median_ms``): 4 launches of the batched kernel on (4, n) row blocks
    against 4 sub-masters, beside one launch over all 16 rows against one
    master, each with its byte bound (every input read once, every output
    written once, at the card's memory rate of record)."""
    from repro_torch.core.dynamic_weight import group_assignment
    from repro_torch.kernels.elastic import ops as ela

    bw = card_rates(torch.cuda.get_device_name(0))[1][0]
    gen = torch.Generator("cuda").manual_seed(18)
    w = torch.randn(16, N, generator=gen, device="cuda")
    sm = torch.randn(4, N, generator=gen, device="cuda")
    m = torch.randn(N, generator=gen, device="cuda")
    h = torch.rand(2, 16, generator=gen, device="cuda") * 0.3
    grp = group_assignment(16, 4)
    out = {
        "grouped_4_racks_ms": median_ms(
            torch, lambda: ela.elastic_update_grouped(w, sm, h, grp)),
        "grouped_bound_ms": ((2 * 16 + 2 * 4) * 4 * N + 8 * 16) / bw * 1e3,
        "batched_k16_ms": median_ms(
            torch, lambda: ela.elastic_update_batched(w, m, h)),
        "batched_k16_bound_ms": ((2 * 16 + 2) * 4 * N + 8 * 16) / bw * 1e3}
    log(f"  rack exchange, 16 rows in 4 racks: {out['grouped_4_racks_ms']:.4f}"
        f" ms (bound {out['grouped_bound_ms']:.4f}); one batched launch over "
        f"16 rows: {out['batched_k16_ms']:.4f} ms (bound "
        f"{out['batched_k16_bound_ms']:.4f})")
    return out


def hierarchy_device_parity(torch):
    """Phase 5h, last: 3 rounds of DEAHES-O at capacity 7 in racks of
    3/2/2, a global sync every 2 rounds, on the card (kernels) and on the
    CPU (plain versions) from the same carried params and probes; the
    master and every sub-master agree at phase 5's tolerance
    (``_leaf_parity``, norm-wise 1e-4)."""
    import numpy as np

    from repro_torch.api.session import ElasticSession, RunSpec
    from repro_torch.configs.base import (ElasticConfig, OptimizerConfig,
                                          get_config)
    from repro_torch.kernels.flatten import FlatLayout
    from repro_torch.models.cnn import PaperCNN
    from repro_torch.nn.param import init_tree

    spec_tree = PaperCNN(get_config("paper-cnn")).spec
    layout = FlatLayout(spec_tree)
    params = init_tree(torch.Generator().manual_seed(6), spec_tree)

    def probes(device):
        def fn(r, t, i):
            rng = np.random.default_rng([14, r, t, i])
            z = rng.integers(0, 2, (1, layout.n)).astype(np.float32) * 2 - 1
            return torch.from_numpy(z).to(device)
        return fn

    states = {}
    for device in ("cuda", "cpu"):
        spec = RunSpec(
            optimizer=OptimizerConfig(name="adahessian"),
            elastic=ElasticConfig(num_workers=7, tau=1, comm_mode="fused",
                                  groups=3, global_period=2),
            rounds=3, batch_size=32, n_data=2000, n_test=100, device=device)
        sess = ElasticSession(spec, params=params, probe_fn=probes(device))
        recs = sess.run()
        states[device] = {key: sess.state[key].cpu().double()
                          for key in ("master", "submasters")}
        states[device]["g_h2"] = [r.g_h2.tolist() for r in recs]
    got, want = states["cuda"], states["cpu"]
    if [any(x) for x in got["g_h2"]] != [False, True, False]:
        raise AssertionError(f"card: g_h2 per round {got['g_h2']}")
    worst = [_leaf_parity(torch, layout, got["master"], want["master"],
                          "hierarchy master", 1e-4)]
    for g in range(3):
        worst.append(_leaf_parity(torch, layout, got["submasters"][g],
                                  want["submasters"][g],
                                  f"hierarchy sub-master {g}", 1e-4))
    worst_norm = max(w[0] for w in worst)
    worst_abs = max(w[1] for w in worst)
    log(f"  capacity 7, racks 3/2/2, 3 rounds: cuda vs cpu master and "
        f"sub-masters max abs err {worst_abs:.3g}, worst leaf norm-wise "
        f"{worst_norm:.3g}")
    return {"max_abs_err": worst_abs, "worst_leaf_norm_rel": worst_norm}


SHARDED_BASE = ["--workers", "8", "--tau", "4", "--rounds", "8",
                "--comm-mode", "fused"]
SHARDED_HIER = ["--workers", "7", "--groups", "3", "--global-period", "2"]


def sharded_rank(torch, rank: int, world: int, port: int, out_dir: str):
    """One rank of phase 5p (b)-(c), in a process of its own:
    ``launch/train.py``'s ``main`` with the multi-process flags, flat
    (k=8) and then hierarchical (7 workers padded to 8, racks 3/3/2) in
    the same process group. A one-round run of the flat flags first pays
    the process's one-time costs (the group's rendezvous, the CUDA and
    cuDNN start-up), timed; then the rank waits for the file ``go`` in
    ``out_dir``, which the parent writes once it no longer uses the card.
    Per run it records the kernel launches and the rows each launch
    covered, the round ms, every ``gather_rows`` call of the comm phase
    timed between two ``synchronize()`` calls with its bytes, the printed
    ``final master l2``; the master (and sub-masters) go to ``out_dir``
    for the parent to compare."""
    import repro_torch.core.coordinator as coord
    from repro_torch.kernels import kernels, reset_launch_counts
    from repro_torch.kernels.adahessian import ops as ada
    from repro_torch.kernels.elastic import ops as ela
    from repro_torch.launch.train import main

    rows, gathers = [], []
    for kern, k_at in ((ada.KERNEL, 6), (ela.BATCHED_KERNEL, 4)):
        def launch(*args, _real=kern.launch, _name=kern.name, _k=k_at):
            rows.append((_name, int(args[_k])))
            _real(*args)
        kern.launch = launch
    real_gather = coord.gather_rows

    def timed_gather(local, group=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_gather(local, group)
        torch.cuda.synchronize()
        gathers.append(((time.perf_counter() - t0) * 1e3,
                        out.numel() * out.element_size()))
        return out

    coord.gather_rows = timed_gather
    multi = ["--placement", "sharded", "--coordinator-address",
             f"127.0.0.1:{port}", "--num-processes", str(world),
             "--process-id", str(rank)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        main(SHARDED_BASE + multi + ["--rounds", "1"])
    result = {"warm_up_s": time.perf_counter() - t0}
    while not os.path.exists(os.path.join(out_dir, "go")):
        time.sleep(0.05)
    for kind, argv in (("flat", SHARDED_BASE + multi),
                       ("hier", SHARDED_BASE + SHARDED_HIER + multi)):
        rows.clear()
        gathers.clear()
        reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            sess, recs = main(argv)
        text = buf.getvalue()
        n_rounds = len(recs)
        big = [g for g in gathers if g[1] > 1 << 20]  # the worker rows
        result[kind] = {
            "launches": {n: x.launches for n, x in kernels().items()
                         if x.launches},
            "rows": sorted({f"{n}:{k}": sum(1 for r in rows if r == (n, k))
                            for n, k in set(rows)}.items()),
            "round_ms": [r.round_ms for r in recs],
            "gather_ms": [g[0] for g in big],
            "gather_bytes_per_round": sum(g[1] for g in gathers) // n_rounds,
            "l2": re.search(r"final master l2=(\S+)", text).group(1),
            "backend": torch.distributed.get_backend(),
            "round_lines": text.count("round "),
            "g_h2": [r.g_h2.tolist() for r in recs] if kind == "hier"
            else None,
            "losses": [r.loss for r in recs]}
        state = {"master": sess.state["master"].cpu()}
        if kind == "hier":
            state["submasters"] = sess.state["submasters"].cpu()
        torch.save(state, os.path.join(out_dir, f"{kind}{rank}.pt"))
        del sess
    torch.distributed.destroy_process_group()
    print("RANK_RESULT " + json.dumps(result), flush=True)


def _spawn_ranks(world: int, out_dir: str, meanwhile=lambda: None,
                 timeout: float = 300):
    """Phase 5p's ranks: ``world`` processes of this script, each one
    rank (``--sharded-rank``), on a free local port. ``meanwhile()`` runs
    here while they start up; then the file ``go`` releases them. Every
    process is ended before this returns. Returns each rank's result
    record and what ``meanwhile`` returned."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank",
         str(rank), str(world), str(port), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = []
    try:
        here = meanwhile()
        open(os.path.join(out_dir, "go"), "w").close()
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    results = []
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        found = [line for line in out.splitlines()
                 if line.startswith("RANK_RESULT ")]
        if proc.returncode or not found:
            raise AssertionError(f"rank {rank} exited {proc.returncode}:\n"
                                 f"{out[-3000:]}")
        results.append(json.loads(found[-1][len("RANK_RESULT "):]))
    return results, here


def sharded_cli(torch):
    """Phase 5p: sharded placement on the card through ``launch/train.py``
    at PaperCNN's full width, DEAHES-O fused, τ=4, 8 rounds.

    (a) ``--placement sharded`` at world size 1 (no process group), k=8,
        beside ``--placement single`` with the same seeds: masters bit for
        bit, K1 32 and K2 8 launches in each; run here while the two rank
        processes of (b) start up;
    (b) two processes on the one card (``--coordinator-address
        127.0.0.1:P --num-processes 2 --process-id {0,1}``, gloo with CUDA
        tensors), k=8, 4 slots per rank: both ranks' ``final master l2``
        and masters identical; against (a)'s single run, the max abs
        difference and whether it is bit-exact (else within phase 5's
        tolerance); per rank K1 32 launches on 4 rows, K2 8 on 8 rows,
        round ms, and the comm phase's gather ms and bytes per round;
    (c) the same two ranks, hierarchical: 7 workers padded to 8 slots,
        ``--groups 3 --global-period 2`` (racks 3/3/2, rack 1 on both
        ranks), against single placement at capacity 8: masters and
        sub-masters identical across ranks and within phase 5h's tolerance
        of single placement, g_h2 non-zero on the sync rounds only;
    (d) only with two or more cards: (b) again, one card per rank, over
        NCCL; otherwise one line saying why it did not run."""
    import numpy as np

    from repro_torch.kernels.flatten import FlatLayout
    from repro_torch.models.cnn import PaperCNN
    from repro_torch.configs.base import get_config

    K1, K2 = "adahessian_update_batched", "elastic_update_batched"
    layout = FlatLayout(PaperCNN(get_config("paper-cnn")).spec)
    out = {}

    def world1():
        """(a), while the ranks start up: single placement and sharded
        placement at world size 1, flat, then single placement of (c)'s
        hierarchy; their masters (and sub-masters) on the host."""
        single, recs_s, _, _, _ = _cli_run(
            torch, "single k=8", SHARDED_BASE, {K1: 32, K2: 8})
        w1, recs_w1, _, _, _ = _cli_run(
            torch, "sharded world 1 k=8",
            SHARDED_BASE + ["--placement", "sharded"], {K1: 32, K2: 8})
        if not torch.equal(w1.state["master"], single.state["master"]):
            raise AssertionError("sharded at world size 1: master differs "
                                 "from single placement")
        out["world1"] = {
            "bitwise_vs_single": True,
            "round_ms_single": statistics.median(r.round_ms
                                                 for r in recs_s[1:]),
            "round_ms_sharded": statistics.median(r.round_ms
                                                  for r in recs_w1[1:])}
        log(f"    (a) world size 1: master bit for bit with single "
            f"placement; round ms single "
            f"{out['world1']['round_ms_single']:.2f}, sharded "
            f"{out['world1']['round_ms_sharded']:.2f} (the two rank "
            "processes start up beside these runs)")
        hier, _, _, _, _ = _cli_run(
            torch, "single hier 7 of 8 slots",
            SHARDED_BASE + SHARDED_HIER + ["--capacity", "8"],
            {K1: 32, K2: 8 * 3 + 4})
        return (single.state["master"].cpu(), hier.state["master"].cpu(),
                hier.state["submasters"].cpu())

    # (a), then (b) + (c): two ranks on the one card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks, singles = _spawn_ranks(2, tmp, world1)
        spawn_s = time.perf_counter() - t0
        master_single, hier_master_single, subs_single = singles
        load = lambda kind, r: torch.load(os.path.join(tmp, f"{kind}{r}.pt"))
        flat = [load("flat", r) for r in range(2)]
        hier = [load("hier", r) for r in range(2)]
    for kind in ("flat", "hier"):
        l2s = [r[kind]["l2"] for r in ranks]
        if l2s[0] != l2s[1]:
            raise AssertionError(f"(b/c) {kind}: ranks' final master l2 "
                                 f"differ: {l2s}")
        if [r[kind]["round_lines"] for r in ranks] != [
                len(ranks[0][kind]["round_ms"]), 0]:
            raise AssertionError(f"{kind}: round lines per rank "
                                 f"{[r[kind]['round_lines'] for r in ranks]}")
    want_rows = {"flat": [[f"{K1}:4", 32], [f"{K2}:8", 8]],
                 "hier": [[f"{K1}:4", 32], [f"{K2}:2", 8], [f"{K2}:3", 20]]}
    for rank, r in enumerate(ranks):
        for kind in ("flat", "hier"):
            if r[kind]["rows"] != want_rows[kind]:
                raise AssertionError(f"rank {rank} {kind}: launches by rows "
                                     f"{r[kind]['rows']}, expected "
                                     f"{want_rows[kind]}")
            if r[kind]["backend"] != "gloo":
                raise AssertionError(f"rank {rank}: backend "
                                     f"{r[kind]['backend']}, not gloo")
    if not torch.equal(flat[0]["master"], flat[1]["master"]):
        raise AssertionError("(b) the two ranks' masters differ")
    diff = float((flat[0]["master"] - master_single).abs().max())
    bitwise = bool(torch.equal(flat[0]["master"], master_single))
    worst = _leaf_parity(torch, layout, flat[0]["master"].double(),
                         master_single.double(), "(b) 2 ranks vs single",
                         1e-4)
    for key in ("master", "submasters"):
        if not torch.equal(hier[0][key], hier[1][key]):
            raise AssertionError(f"(c) the two ranks' {key} differ")
    hier_bitwise = bool(torch.equal(hier[0]["master"], hier_master_single)
                        and torch.equal(hier[0]["submasters"], subs_single))
    hier_worst = [_leaf_parity(torch, layout, hier[0]["master"].double(),
                               hier_master_single.double(),
                               "(c) master vs single", 1e-4)]
    for g in range(3):
        hier_worst.append(_leaf_parity(
            torch, layout, hier[0]["submasters"][g].double(),
            subs_single[g].double(), f"(c) sub-master {g} vs single", 1e-4))
    syncs = [bool(np.any(g)) for g in ranks[0]["hier"]["g_h2"]]
    if syncs != [r % 2 == 1 for r in range(len(syncs))]:
        raise AssertionError(f"(c) g_h2 non-zero on rounds {syncs}")
    for rank, r in enumerate(ranks):
        for kind in ("flat", "hier"):
            rk = r[kind]
            log(f"    ({'b' if kind == 'flat' else 'c'}) rank {rank} {kind}: "
                f"launches by rows {rk['rows']}; round ms median "
                f"{statistics.median(rk['round_ms'][1:]):.2f} (first "
                f"{rk['round_ms'][0]:.1f}); gather of the worker rows "
                f"median {statistics.median(rk['gather_ms']):.2f} ms, "
                f"{rk['gather_bytes_per_round']} bytes a round; l2 {rk['l2']}")
    log(f"    (b) two ranks vs single: master max abs diff {diff:.3g}, "
        f"bit-exact {bitwise}, worst leaf norm-wise {worst[0]:.3g}")
    log(f"    (c) two ranks vs single: master and sub-masters bit-exact "
        f"{hier_bitwise}, max abs diff {max(w[1] for w in hier_worst):.3g}, "
        f"worst leaf norm-wise {max(w[0] for w in hier_worst):.3g}; g_h2 on "
        f"sync rounds only; (a) to (c) took {spawn_s:.1f} s, each rank's "
        f"one-round warm-up {[round(r['warm_up_s'], 1) for r in ranks]} s")
    out["two_ranks"] = {
        "backend": "gloo", "cards": 1, "ranks": ranks, "spawn_s": spawn_s,
        "flat_vs_single": {"bitwise": bitwise, "max_abs_diff": diff,
                           "worst_leaf_norm_rel": worst[0]},
        "hier_vs_single": {"bitwise": hier_bitwise,
                           "max_abs_diff": max(w[1] for w in hier_worst),
                           "worst_leaf_norm_rel": max(w[0]
                                                      for w in hier_worst)}}
    out["launches_per_rank"] = {kind: ranks[0][kind]["launches"]
                                for kind in ("flat", "hier")}
    # (d) NCCL, one card per rank
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory() as tmp:
            nccl, _ = _spawn_ranks(2, tmp)
            masters = [torch.load(os.path.join(tmp, f"flat{r}.pt"))["master"]
                       for r in range(2)]
        if (any(r["flat"]["backend"] != "nccl" for r in nccl)
                or not torch.equal(masters[0], masters[1])):
            raise AssertionError("(d) nccl: backend or masters differ")
        out["nccl"] = nccl
        log(f"    (d) nccl, one card per rank: masters identical, gather "
            f"median {statistics.median(nccl[0]['flat']['gather_ms']):.2f} "
            "ms")
    else:
        out["nccl"] = None
        log(f"    (d) nccl: not run — {torch.cuda.device_count()} card "
            "visible, NCCL needs one card per rank")
    return out


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
                              batch=8, watch=None)
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
    stats = _served_stats(torch, sched, results, lm, wall, 16, 64)
    served, toks = stats["served"], stats["tokens"]
    stats.update({"requests": len(results), "req_s": served / sched.vnow,
                  "flash_launches": launches["flash_attention_fwd"]})
    log(f"  continuous: served {served}/{len(results)}, {toks} tokens, "
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


def profile_serving(torch, model, params, capacity=8, max_len=577,
                    tick_reps=3):
    """Phase 6b (and 6m): where a decode tick and an admit spend their
    time. One ``torch.profiler`` window over ``tick_reps`` pooled decode
    steps (``capacity`` rows, every row at position 512 of a ``max_len``
    cache) and one over 1 prefill of 512 tokens; device busy share = the
    union of kernel intervals over the window's wall time, closed by
    ``synchronize()``."""
    dev = torch.device("cuda")
    cache = model.init_cache(capacity, max_len, dev)
    tok = torch.zeros(capacity, 1, dtype=torch.long, device=dev)
    idx = torch.full((capacity, 1), 512, device=dev)
    prompt = torch.zeros(1, 512, dtype=torch.long, device=dev)
    scratch = model.init_cache(1, 512, dev)
    calls = {
        "decode tick": (tick_reps, lambda: model.decode_step(
            params, {"tokens": tok}, cache, idx)),
        "admit prefill": (1, lambda: model.prefill(
            params, {"tokens": prompt}, scratch)),
    }
    with torch.no_grad():
        return {name: profile_window(torch, name, fn, reps)
                for name, (reps, fn) in calls.items()}


def profile_window(torch, name, fn, reps):
    """One ``torch.profiler`` window over ``reps`` calls of ``fn`` after
    one warm-up call: wall time per call (closed by ``synchronize()``),
    device busy time (the union of kernel intervals) and its share of the
    wall time, kernels per call, and the top five kernels by device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the raw kineto events: ``prof.events()`` builds the whole CPU op
    # tree in Python first, tens of seconds for a blockwise admit's
    # ~70,000 kernels and their host ops
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, kname in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[kname] = by_name.get(kname, 0.0) + stop - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"  {name}: {wall_us / reps / 1e3:.2f} ms wall, device busy "
        f"{busy / reps / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
        f"{len(spans) // reps} kernels; top device time: "
        + "; ".join(f"{k[:60]} {v / reps / 1e3:.3f} ms" for k, v in top))
    return {"wall_ms": wall_us / reps / 1e3,
            "device_busy_ms": busy / reps / 1e3,
            "device_busy_share": busy / wall_us,
            "kernels": len(spans) // reps,
            "top_ms": {k: v / reps / 1e3 for k, v in top}}


# phases 7e and 7v: the cut of each new family for card vs CPU (float32,
# full width): seamless-m4t-large-v2 at 2 encoder + 2 decoder layers,
# qwen2-vl-7b at 2 layers with 64 patches (a grid of 8) before its text
FAMILY_PARITY = {
    "seamless-m4t-large-v2": dict(enc_layers=2, dec_layers=2, num_layers=4),
    "qwen2-vl-7b": dict(num_layers=2, num_patch_tokens=64),
}


def serving_device_parity(torch, arch="qwen3-4b", S=512):
    """Phase 7 (and 7b (b), 7m, 7e, 7v): the serving path on the card and
    on the CPU (plain versions) from the same params: ``arch`` at full
    width cut to 2 layers, float32 (moonshot-v1-16b-a3b: its dense layer
    and one MoE layer; the new families as ``FAMILY_PARITY`` cuts them).
    Prefill S inputs into an S-position cache (as an admit: qwen3-4b and
    moonshot at 512 take the flash branch, the kernel once a layer on the
    card; stablelm-3b and h2o-danube-1.8b at 1024 take
    ``blockwise_attention``, once per layer on each device;
    seamless-m4t-large-v2 encodes S frames, K5 non-causal once an encoder
    layer, and its decoder's S tokens take K5 causal in self-attention and
    non-causal in cross-attention; qwen2-vl-7b's S inputs are its patches
    and then text, K5 causal under M-RoPE), adopt the cache into S + 4
    positions (an encoder-decoder's cross K/V as the prefill left them),
    then 4 greedy decode steps at the global index fed the CPU's tokens.
    Logits agree within 1e-3 of the logit scale (max |logit|): float32
    matmuls in other summation orders over d_model 1024-3584 and d_ff
    6912-18944. An MoE model's routers choose the same experts on both
    devices (``check_routes``). Returns the worst relative error and the
    card's launch counts."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models.registry import build_model
    from repro_torch.nn import layers, moe
    from repro_torch.nn.param import init_tree, tree_from_leaves, tree_leaves

    cfg = get_config(arch).replace(**{
        "num_layers": 2, "dtype": "float32", "param_dtype": "float32",
        **FAMILY_PARITY.get(arch, {})})
    model = build_model(cfg)
    cpu = init_tree(torch.Generator().manual_seed(1), model.spec)
    card = tree_from_leaves((p, t.cuda()) for p, t in tree_leaves(cpu))
    rng = np.random.default_rng(2)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (1, S))}
    if cfg.family == "encdec":  # as many frames as tokens: Sq == Skv
        inputs["src"] = rng.standard_normal((1, S, cfg.d_model),
                                            dtype=np.float32)
    if cfg.family == "vlm":
        n = cfg.num_patch_tokens
        inputs["patches"] = rng.standard_normal((1, n, cfg.d_model),
                                                dtype=np.float32)
        inputs["tokens"] = inputs["tokens"][:, :S - n]
    outs = {}
    feed = []
    bw, _ = blockwise_watch()
    routes, flash_causal = {}, {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        reset_launch_counts()
        rw = CallWatch(moe, "route", lambda a, kw, out: (
            out[0].cpu(), out[2].cpu()))
        fw = CallWatch(layers, "flash_attention_bshd",
                       lambda a, kw, out: kw["causal"])
        with torch.no_grad(), bw, rw, fw:
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in inputs.items()}
            logits, scratch = model.prefill(params, batch,
                                            model.init_cache(1, S, dev))
            cache = dict(tree_leaves(model.init_cache(1, S + 4, dev)))
            for path, leaf in tree_leaves(scratch):
                if path[-1] in ("k", "v"):
                    cache[path][:, :, :S] = leaf
                else:
                    cache[path] = leaf
            cache = tree_from_leaves(cache.items())
            steps = [logits.float().cpu()]
            for i in range(4):
                if dev == "cpu":
                    feed.append(steps[-1][:, -1:].argmax(-1))
                logits, cache = model.decode_step(
                    params, {"tokens": feed[i].to(dev)}, cache, S + i)
                steps.append(logits.float().cpu())
        outs[dev] = steps
        routes[dev] = rw.calls
        flash_causal[dev] = fw.calls
    launches = _launches(torch)
    worst = 0.0
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not bool(torch.isfinite(a).all()) or err > 1e-3 * scale:
            raise AssertionError(f"serving card vs CPU, call {i}: max abs "
                                 f"err {err:.3g} > 1e-3 x {scale:.3g}")
        worst = max(worst, err / scale)
        log(f"  {arch} {'prefill' if i == 0 else f'decode {i}'}: max abs "
            f"err {err:.3g} (logit scale {scale:.3g})")
    want_calls = 2 * cfg.num_layers if S >= 1024 else 0
    if len(bw.calls) != want_calls:
        raise AssertionError(f"{arch}: {len(bw.calls)} blockwise calls, "
                             f"expected {want_calls}")
    flash = S % 128 == 0 and cfg.hd in (64, 128) and cfg.rotary_pct == 1.0
    # an encoder-decoder: the encoder's layers non-causal, then each
    # decoder layer's self-attention causal and its cross-attention not
    want_causal = ([False] * cfg.enc_layers + [True, False] * cfg.dec_layers
                   if cfg.family == "encdec" else [True] * cfg.num_layers)
    want = {n: 0 for n in launches}
    want["flash_attention_fwd"] = len(want_causal) if flash else 0
    if launches != want or flash_causal["cuda"] != (
            want_causal if flash else []) or (
            flash_causal["cpu"] != flash_causal["cuda"]):
        raise AssertionError(f"{arch} card launches {launches}, K5 causal "
                             f"flags {flash_causal['cuda']}; expected "
                             f"{want}, {want_causal}")
    log(f"  {arch}: K5 {launches['flash_attention_fwd']} launches on the "
        f"card ({sum(flash_causal['cuda'])} causal), the flash branch "
        f"{len(flash_causal['cpu'])} times on the CPU")
    if cfg.moe:
        flips = check_routes(torch, routes["cuda"], routes["cpu"],
                             model.n_moe * 5)
        log(f"  {arch}: {len(routes['cuda'])} router calls, chosen experts "
            f"card = CPU except {flips} token(s) within the devices' "
            "disagreement")
    return worst, launches


def check_routes(torch, card, cpu, n_calls):
    """Phase 7m: the experts each router call chose on the card, in order,
    equal the CPU's. Where a token's choice differs, the phase proves the
    router margin there is below what the two devices' float32 arithmetic
    disagrees by: the CPU's probabilities of the card's choice equal the
    CPU's own top-k probabilities within twice the largest card-vs-CPU
    difference of that token's probabilities. Returns the tokens that
    differ."""
    if len(card) != n_calls or len(cpu) != n_calls:
        raise AssertionError(f"{len(card)} / {len(cpu)} router calls, "
                             f"expected {n_calls}")
    flips = 0
    for i, ((p_card, e_card), (p_cpu, e_cpu)) in enumerate(zip(card, cpu)):
        differ = (e_card != e_cpu).any(-1)  # (B, S)
        for b, t in differ.nonzero().tolist():
            delta = float((p_card[b, t] - p_cpu[b, t]).abs().max())
            ours = p_cpu[b, t, e_card[b, t]]
            best = p_cpu[b, t].sort(descending=True).values[:ours.numel()]
            gap = float((best - ours).abs().max())
            if gap > 2 * delta:
                raise AssertionError(
                    f"router call {i}, token {t}: card chose "
                    f"{e_card[b, t].tolist()}, CPU {e_cpu[b, t].tolist()}; "
                    f"probability gap {gap:.3g} > 2 x {delta:.3g}")
            flips += 1
    return flips


class CallWatch:
    """Records every call of ``module.name`` made inside the ``with`` block
    (the name wrapped where it is looked up): ``record(args, kwargs,
    out)`` of each call, in order, in ``calls``."""

    def __init__(self, module, name, record):
        self.module, self.name, self.record = module, name, record
        self.calls = []

    def __enter__(self):
        fn = self._saved = getattr(self.module, self.name)

        def watched(*a, **kw):
            out = fn(*a, **kw)
            self.calls.append(self.record(a, kw, out))
            return out

        setattr(self.module, self.name, watched)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._saved)


def blockwise_watch():
    """Two ``CallWatch``es: the attention layer's ``blockwise_attention``
    calls and the per-block-pair steps (``nn/flash.py::kv_step``) inside
    them; their counts are ``len(.calls)``."""
    from repro_torch.nn import flash, layers

    return (CallWatch(layers, "blockwise_attention", lambda a, kw, out: None),
            CallWatch(flash, "kv_step", lambda a, kw, out: None))


def wall_ms(torch, fn, reps: int = 5) -> float:
    """Median host wall time of ``fn`` between two ``synchronize()`` calls,
    after one warm-up call: for work that syncs inside itself or is
    bounded by host dispatch, where device events would not bracket it."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _served_stats(torch, sched, results, lm, wall, n_req, n_new):
    """Phase 6's checks and numbers for one continuous run."""
    import numpy as np

    from repro_torch.nn.param import tree_leaves

    served = [r for r in results if r.reason != "rejected"]
    admits = len(lm.times["prefill"])
    if len(served) != n_req or admits != n_req:
        raise AssertionError(f"served {len(served)}/{n_req}, {admits} admits")
    if any(r.num_tokens != n_new for r in served):
        raise AssertionError(f"a request ended short of {n_new} tokens")
    if not bool(lm.finite):
        raise AssertionError("a non-finite logit on the serving path")
    toks = sum(r.num_tokens for r in served)
    ttft = np.array([r.ttft for r in served]) * 1e3
    lat = np.array([r.latency for r in served]) * 1e3
    return {
        "served": len(served), "tokens": toks, "virtual_s": sched.vnow,
        "wall_s": wall, "tok_s": toks / sched.vnow,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "ticks": sched.engine.ticks, "admits": admits,
        "prefill_ms_median": 1e3 * statistics.median(lm.times["prefill"]),
        "decode_tick_ms_median": 1e3 * statistics.median(lm.times["decode"]),
        "kv_cache_bytes": sum(t.nbytes for _, t in
                              tree_leaves(sched.engine.cache)),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


# phases 6s and 6d: (arch, full-size params, continuous run, live block
# pairs per blockwise call) — every admit pads to prompt_len, so every
# admit is one full-sequence call per layer at that length
DENSE_FAMILY = {
    "stablelm-3b": (2_795_443_200, dict(capacity=8, prompt_len=2048,
                                        steps=64, traffic=16), 10),
    "h2o-danube-1.8b": (1_831_201_280, dict(capacity=4, prompt_len=8192,
                                            steps=32, traffic=8), 108),
}


def dense_family_path(torch, arch: str):
    """Phases 6s / 6d: one dense configuration at full size (bf16, random
    weights drawn on the card from a seed) through ``launch/serve.py``'s
    ``serve_continuous``. Counts zeroed just before the run and read just
    after: ``blockwise_attention`` once per layer per admit, the live
    block pairs of each call as the host's block rule predicts, no CUDA
    kernel launched (head_dim 80 is outside the flash kernel's), every
    logit finite. stablelm-3b adds one static ``ServeEngine`` batch at
    prompt 512 (the plain ``gqa_attention`` branch: no blockwise call)."""
    import argparse

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import kernels, reset_launch_counts
    from repro_torch.launch.serve import serve_continuous, serve_static
    from repro_torch.models.registry import build_model
    from repro_torch.nn.param import init_tree, param_count

    n_want, run, pairs = DENSE_FAMILY[arch]
    dev = torch.device("cuda")
    cfg = get_config(arch)
    model = build_model(cfg)
    n_params = param_count(model.spec)
    if n_params != n_want:
        raise AssertionError(f"{arch} has {n_params:,} params")
    params = init_tree(torch.Generator(dev).manual_seed(0), model.spec, dev)
    log(f"  {arch}: {n_params:,} params ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.kv_heads} heads of {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, norm {cfg.norm}, rotary "
        f"{cfg.rotary_pct}, window {cfg.sliding_window}, tied "
        f"{cfg.tie_embeddings}, {cfg.dtype})")

    lm = WatchedLM(torch, model)
    args = argparse.Namespace(eos_id=None, poll_every=8, batch=8,
                              watch=None, **run)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    bw, bp = blockwise_watch()
    with bw, bp:
        t0 = time.perf_counter()
        sched, results = serve_continuous(lm, params, args, cfg.vocab_size)
        wall = time.perf_counter() - t0
    n_calls, n_pairs = len(bw.calls), len(bp.calls)
    launches = {n: x.launches for n, x in kernels().items()}
    stats = _served_stats(torch, sched, results, lm, wall, run["traffic"],
                          run["steps"])
    admits = stats["admits"]
    if any(launches.values()):
        raise AssertionError(f"{arch} serving launched {launches}")
    if n_calls != admits * cfg.num_layers or n_pairs != n_calls * pairs:
        raise AssertionError(
            f"{arch}: {n_calls} blockwise calls, {n_pairs} block pairs; "
            f"expected {admits} admits x {cfg.num_layers} layers, {pairs} "
            "pairs each")
    n_blocks = (run["prompt_len"] // 512) ** 2
    stats.update({"params": n_params, "blockwise_calls": n_calls,
                  "live_block_pairs_per_call": pairs,
                  "block_pairs_per_call": n_blocks,
                  "flash_launches": launches["flash_attention_fwd"],
                  **{k: run[k] for k in ("capacity", "prompt_len", "steps",
                                         "traffic")}})
    log(f"  continuous: {stats['served']} requests, {stats['tokens']} "
        f"tokens, {stats['tok_s']:.1f} tok/s over {sched.vnow:.3f} s virtual "
        f"({wall:.3f} s wall), TTFT p50 {stats['ttft_ms_p50']:.1f} / p99 "
        f"{stats['ttft_ms_p99']:.1f} ms, latency p50 "
        f"{stats['latency_ms_p50']:.1f} / p99 {stats['latency_ms_p99']:.1f} "
        f"ms; {stats['ticks']} decode ticks of median "
        f"{stats['decode_tick_ms_median']:.2f} ms, admit median "
        f"{stats['prefill_ms_median']:.2f} ms; blockwise calls {n_calls} = "
        f"{admits} admits x {cfg.num_layers} layers, {pairs} of {n_blocks} "
        f"block pairs each; flash launches 0; KV cache "
        f"{stats['kv_cache_bytes']:,} B; peak memory "
        f"{stats['max_memory_allocated_gb']:.2f} GB")

    if arch == "stablelm-3b":
        lm = WatchedLM(torch, model)
        static = argparse.Namespace(batch=8, prompt_len=512, steps=32,
                                    eos_id=None)
        reset_launch_counts()
        bw, _ = blockwise_watch()
        with bw:
            tok_s = serve_static(lm, params, static, cfg.vocab_size, dev)
        moved = {n: x.launches for n, x in kernels().items()}
        if any(moved.values()) or bw.calls:
            raise AssertionError(f"static batch: {moved}, {len(bw.calls)} "
                                 "blockwise calls")
        if not bool(lm.finite):
            raise AssertionError("a non-finite logit in the static batch")
        decode = lm.times["decode"][-31:]
        stats.update({"static_tok_s": tok_s,
                      "static_decode_step_ms_median":
                          1e3 * statistics.median(decode),
                      "static_prefill_ms": 1e3 * lm.times["prefill"][-1]})
        log(f"  static: 8 x 512 prompt, 32 steps (gqa_attention): "
            f"{tok_s:.1f} tok/s, decode step median "
            f"{stats['static_decode_step_ms_median']:.2f} ms, prefill "
            f"{stats['static_prefill_ms']:.2f} ms")

    S = run["prompt_len"]
    prompt = torch.zeros(1, S, dtype=torch.long, device=dev)
    scratch = model.init_cache(1, S, dev)
    with torch.no_grad():
        stats["profile_admit"] = profile_window(
            torch, f"{arch} admit prefill ({S} tokens, blockwise)",
            lambda: model.prefill(params, {"tokens": prompt}, scratch), 1)
    del params, scratch, sched, lm
    torch.cuda.empty_cache()
    return stats


# phases 6m and 6x: (layers kept (None: all), params, continuous run,
# profiled); bf16, weights drawn on the card
MOE_SERVE = {
    "moonshot-v1-16b-a3b": (None, 28_386_592_768, dict(
        capacity=4, prompt_len=512, steps=32, traffic=8), True),
    "mixtral-8x22b": (2, 5_410_781_184, dict(
        capacity=2, prompt_len=8192, steps=8, traffic=2), False),
    "llama4-scout-17b-a16e": (2, 6_473_180_160, dict(
        capacity=2, prompt_len=12288, steps=8, traffic=2), False),
}


def moe_admit(arch: str):
    """K5's call on an admit of phases 6m / 6x: (B, H, KVH, S, D) and the
    mask the config passes (its window or its chunk; causal always)."""
    from repro_torch.configs.base import get_config

    cfg = get_config(arch)
    mask = {key: val for key, val in (("window", cfg.sliding_window),
                                      ("chunk", cfg.attention_chunk)) if val}
    return (1, cfg.num_heads, cfg.kv_heads, MOE_SERVE[arch][2]["prompt_len"],
            cfg.hd), mask


def moe_serving_path(torch, arch: str):
    """Phases 6m / 6x: one MoE configuration through ``launch/serve.py``'s
    ``serve_continuous`` in bf16, random weights drawn on the card from a
    seed: moonshot-v1-16b-a3b at full size (6m), mixtral-8x22b and
    llama4-scout-17b-a16e at full width cut to 2 layers (6x). Counts zeroed
    just before the run and read just after: the flash kernel (K5) once a
    layer per admit and nothing else, every K5 call at the admit's shape
    (1, prefill_len) with the config's window or chunk passed, the MoE
    layer (``nn/moe.py`` ``apply_moe``) once per MoE layer per admit and
    per decode tick, every logit finite. 6m adds a ``torch.profiler``
    window over one admit and one tick. Frees everything it drew before
    it returns."""
    import argparse

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models.registry import build_model
    from repro_torch.nn import moe
    from repro_torch.nn.param import init_tree, param_count

    n_layers, n_want, run, profiled = MOE_SERVE[arch]
    mask = moe_admit(arch)[1]
    gc.collect()  # earlier phases' engines sit in reference cycles
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(num_layers=n_layers)
    model = build_model(cfg)
    n_params = param_count(model.spec)
    if n_params != n_want:
        raise AssertionError(f"{arch} has {n_params:,} params")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_tree(torch.Generator(dev).manual_seed(0), model.spec, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  {arch}: {n_params:,} params ({cfg.num_layers} layers: "
        f"{model.n_dense} dense + {model.n_moe} MoE; d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.kv_heads} heads of {cfg.hd}, {cfg.num_experts}"
        f" experts top-{cfg.top_k} of d_ff {cfg.e_dff}, "
        f"{cfg.num_shared_experts} shared, vocab {cfg.vocab_size}, window "
        f"{cfg.sliding_window}, chunk {cfg.attention_chunk}, {cfg.dtype}) "
        f"drawn on the card in {init_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    lm = WatchedLM(torch, model)
    args = argparse.Namespace(eos_id=None, poll_every=8, batch=8,
                              watch=None, **run)
    reset_launch_counts()
    fw = _flash_watch()
    mw = CallWatch(moe, "apply_moe", lambda a, kw, out: tuple(
        a[1].shape[:2]))
    with fw, mw:
        t0 = time.perf_counter()
        sched, results = serve_continuous(lm, params, args, cfg.vocab_size)
        wall = time.perf_counter() - t0
    launches = _launches(torch)
    stats = _served_stats(torch, sched, results, lm, wall, run["traffic"],
                          run["steps"])
    admits, ticks = stats["admits"], stats["ticks"]
    S, H, KVH, D = run["prompt_len"], cfg.num_heads, cfg.kv_heads, cfg.hd
    want = {n: 0 for n in launches}
    want["flash_attention_fwd"] = admits * cfg.num_layers
    if launches != want:
        raise AssertionError(f"{arch} serving launches {launches}, "
                             f"expected {want}")
    call = ((1, S, H, D), (1, S, KVH, D), torch.bfloat16, True,
            mask.get("window"), mask.get("chunk"))
    if fw.calls != [call] * (admits * cfg.num_layers):
        raise AssertionError(f"{arch}: K5 calls {sorted(set(fw.calls))}, "
                             f"expected {admits * cfg.num_layers} x {call}")
    moe_calls = {k: mw.calls.count(k) for k in set(mw.calls)}
    want_moe = {(1, S): admits * model.n_moe,
                (run["capacity"], 1): ticks * model.n_moe}
    if moe_calls != want_moe:
        raise AssertionError(f"{arch}: apply_moe calls by (B, S) "
                             f"{moe_calls}, expected {want_moe}")
    stats.update({"params": n_params, "layers": cfg.num_layers,
                  "init_s": init_s, "launches": launches,
                  "flash_call": [list(call[0]), list(call[1]), "bfloat16",
                                 *call[3:]],
                  "apply_moe_calls": len(mw.calls),
                  **{k: run[k] for k in ("capacity", "prompt_len", "steps",
                                         "traffic")}})
    log(f"  continuous: {stats['served']} requests, {stats['tokens']} "
        f"tokens, {stats['tok_s']:.1f} tok/s over {sched.vnow:.3f} s virtual "
        f"({wall:.3f} s wall), TTFT p50 {stats['ttft_ms_p50']:.1f} / p99 "
        f"{stats['ttft_ms_p99']:.1f} ms, latency p50 "
        f"{stats['latency_ms_p50']:.1f} / p99 {stats['latency_ms_p99']:.1f} "
        f"ms; {ticks} decode ticks of median "
        f"{stats['decode_tick_ms_median']:.2f} ms, admit median "
        f"{stats['prefill_ms_median']:.2f} ms; K5 launches "
        f"{launches['flash_attention_fwd']} = {admits} admits x "
        f"{cfg.num_layers} layers at (1, {S}) {mask or 'causal'}; apply_moe "
        f"{len(mw.calls)} = ({admits} admits + {ticks} ticks) x "
        f"{model.n_moe}; KV cache {stats['kv_cache_bytes']:,} B; peak "
        f"memory {stats['max_memory_allocated_gb']:.2f} GB")
    del sched, results, lm
    if profiled:
        log(f"[6m] profiler: one decode tick (capacity {run['capacity']}) "
            "and one admit's prefill")
        stats["profile"] = profile_serving(
            torch, model, params, capacity=run["capacity"],
            max_len=S + run["steps"] + 1, tick_reps=1)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _flash_watch():
    """A ``CallWatch`` of the attention layer's K5 calls: (q shape, k
    shape, dtype, causal, window, chunk) of each."""
    from repro_torch.nn import layers

    return CallWatch(layers, "flash_attention_bshd", lambda a, kw, out: (
        tuple(a[0].shape), tuple(a[1].shape), a[0].dtype, kw.get("causal"),
        kw.get("window"), kw.get("chunk")))


def _family_model(torch, arch, n_want):
    """``arch`` at full size, bf16 weights drawn on the card from a seed,
    after a ``gc.collect()`` (earlier phases leave engines in reference
    cycles): (cfg, model, params, init s)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.nn.param import init_tree, param_count

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config(arch)
    model = build_model(cfg)
    n_params = param_count(model.spec)
    if n_params != n_want:
        raise AssertionError(f"{arch} has {n_params:,} params")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_tree(torch.Generator(dev).manual_seed(0), model.spec, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  {arch}: {n_params:,} params ({cfg.family}; d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.kv_heads} heads of {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}) drawn on "
        f"the card in {init_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return cfg, model, params, init_s


# phase 6e: requests, prompt tokens, new tokens, source frames a request
ENCDEC_SERVE = dict(batch=4, prompt_len=128, steps=32, frames=512)


def encdec_serving_path(torch):
    """Phase 6e: seamless-m4t-large-v2 at full size (24 encoder + 24
    decoder layers, bf16 weights drawn on the card) through
    ``ServeEngine.generate`` with ``extra_batch={"src": ...}``: 4 requests
    of 128 prompt tokens and 512 frame embeddings each (a numpy seed: the
    frontend is a stub, as in the reference), 32 new tokens, two trials.
    Counts zeroed just before: K5 exactly 24 times a prefill, every call
    non-causal at (4, 512, 16, 16, 64) bf16 (the encoder); the decoder's
    prefill (128 queries over a 161-position cache), its cross-attention
    (128 queries over 512 frames) and every decode tick take
    ``gqa_attention``; nothing else launched; every logit finite. tok/s,
    prefill ms, decode-tick median ms, peak GB; a ``torch.profiler`` window
    over one prefill and one decode tick."""
    import numpy as np

    from repro_torch.kernels import reset_launch_counts
    from repro_torch.serving.engine import ServeEngine

    run = ENCDEC_SERVE
    cfg, model, params, init_s = _family_model(
        torch, "seamless-m4t-large-v2", 2_034_784_256)
    rng = np.random.default_rng(0)
    B, P, n_new = run["batch"], run["prompt_len"], run["steps"]
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    src = rng.standard_normal((B, run["frames"], cfg.d_model),
                              dtype=np.float32)
    lm = WatchedLM(torch, model)
    engine = ServeEngine(lm, params, max_len=P + n_new + 1)
    fw = _flash_watch()
    reset_launch_counts()
    trials = []
    with fw:
        for _ in range(2):
            t0 = time.perf_counter()
            out = engine.generate(prompts, steps=n_new,
                                  extra_batch={"src": src})
            trials.append(time.perf_counter() - t0)
    launches = _launches(torch)
    want = {n: 0 for n in launches}
    want["flash_attention_fwd"] = 2 * cfg.enc_layers
    if launches != want:
        raise AssertionError(f"6e launches {launches}, expected {want}")
    S, H, D = run["frames"], cfg.num_heads, cfg.hd
    call = ((B, S, H, D), (B, S, cfg.kv_heads, D), torch.bfloat16, False,
            None, None)
    if fw.calls != [call] * (2 * cfg.enc_layers):
        raise AssertionError(f"6e K5 calls {sorted(set(fw.calls))}, "
                             f"expected {2 * cfg.enc_layers} x {call}")
    if out.shape != (B, n_new) or not bool(lm.finite):
        raise AssertionError(f"6e: output {out.shape}, finite "
                             f"{bool(lm.finite)}")
    decode = lm.times["decode"][-(n_new - 1):]
    stats = {"params": 2_034_784_256, "init_s": init_s, **run,
             "tok_s": B * n_new / trials[1], "trial_s": trials,
             "prefill_ms": 1e3 * lm.times["prefill"][-1],
             "decode_tick_ms_median": 1e3 * statistics.median(decode),
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches,
             "flash_call": [list(call[0]), list(call[1]), "bfloat16",
                            *call[3:]]}
    log(f"  generate: {B} requests x {P} prompt tokens + {S} frames, "
        f"{n_new} new tokens: {stats['tok_s']:.1f} tok/s (trial 1; trial 0 "
        f"{B * n_new / trials[0]:.1f}), prefill {stats['prefill_ms']:.2f} "
        f"ms, decode tick median {stats['decode_tick_ms_median']:.2f} ms; "
        f"K5 launches {launches['flash_attention_fwd']} = 2 prefills x "
        f"{cfg.enc_layers} encoder layers, non-causal at {call[0]}; peak "
        f"memory {stats['max_memory_allocated_gb']:.2f} GB")
    dev = torch.device("cuda")
    batch = {"tokens": torch.as_tensor(prompts, device=dev),
             "src": torch.as_tensor(src, device=dev)}
    tok = torch.zeros(B, 1, dtype=torch.long, device=dev)
    with torch.no_grad():
        _, cache = model.prefill(params, batch,
                                 model.init_cache(B, P + n_new + 1, dev))
        stats["profile"] = {
            "prefill": profile_window(torch, "prefill", lambda: model.prefill(
                params, batch, model.init_cache(B, P + n_new + 1, dev)), 1),
            "decode tick": profile_window(
                torch, "decode tick", lambda: model.decode_step(
                    params, {"tokens": tok}, cache, P), 1)}
    del params, engine, lm, cache
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# phase 6v (b): patch embeddings (the frontend stub) and text tokens of
# the one image-and-text request, new tokens; the norm-wise tolerance of
# forward's last logits against prefill's (the reference's bf16 decode
# consistency tolerance at SMOKE, rtol/atol 0.06)
VLM_REQUEST = dict(patches=1024, text=128, steps=32, tol=0.06)


def vlm_serving_path(torch):
    """Phase 6v: qwen2-vl-7b at full size (28 layers, bf16 weights drawn
    on the card). (a) ``launch/serve.py``'s static mode, text-only: 8
    prompts of 128 tokens, 32 new, two trials; no K5 (a static prefill has
    Sq < Skv). (b) one image-and-text request, 1024 patch embeddings and
    128 text tokens from a numpy seed: ``VLM.forward`` with K5 exactly 28
    times, causal at (1, 1152, 28, 4, 128) bf16 under M-RoPE; then
    ``VLM.prefill`` into 1152 + 32 positions (``gqa_attention``) and 32
    ``decode_step``s at the global index, the reference's decode
    consistency recipe. Forward's last logits agree with the prefill's
    within ``VLM_REQUEST["tol"]`` of their norm; every logit finite. tok/s,
    prefill ms, decode-tick median ms, peak GB; a ``torch.profiler`` window
    over one forward and one decode tick of (b)."""
    import argparse

    import numpy as np

    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.serve import serve_static

    cfg, model, params, init_s = _family_model(torch, "qwen2-vl-7b",
                                               7_615_487_488)
    dev = torch.device("cuda")
    lm = WatchedLM(torch, model)
    static = argparse.Namespace(batch=8, prompt_len=128, steps=32,
                                eos_id=None)
    reset_launch_counts()
    tok_s = serve_static(lm, params, static, cfg.vocab_size, dev)
    moved = _launches(torch)
    if any(moved.values()) or not bool(lm.finite):
        raise AssertionError(f"6v static: launches {moved}, finite "
                             f"{bool(lm.finite)}")
    decode = lm.times["decode"][-31:]
    stats = {"params": 7_615_487_488, "init_s": init_s, "static": {
        "batch": 8, "prompt_len": 128, "steps": 32, "tok_s": tok_s,
        "prefill_ms": 1e3 * lm.times["prefill"][-1],
        "decode_tick_ms_median": 1e3 * statistics.median(decode)}}
    log(f"  (a) static, text-only: 8 x 128 prompt, 32 steps: {tok_s:.1f} "
        f"tok/s, prefill {stats['static']['prefill_ms']:.2f} ms, decode "
        f"tick median {stats['static']['decode_tick_ms_median']:.2f} ms; "
        "no K5 launch")

    run = VLM_REQUEST
    Np, Nt, n_new = run["patches"], run["text"], run["steps"]
    S = Np + Nt
    rng = np.random.default_rng(1)
    batch = {"patches": torch.as_tensor(rng.standard_normal(
                 (1, Np, cfg.d_model), dtype=np.float32), device=dev),
             "tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (1, Nt)), device=dev)}
    fw = _flash_watch()
    reset_launch_counts()
    ok = torch.ones((), dtype=torch.bool, device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad(), fw:
        (logits, _), fwd_s = timed(lambda: model.forward(params, batch))
        ok &= torch.isfinite(logits).all()
        last_fwd = logits[:, -1].float()
        del logits
        launches = _launches(torch)
        cache = model.init_cache(1, S + n_new, dev)
        (logits, cache), prefill_s = timed(
            lambda: model.prefill(params, batch, cache))
        ok &= torch.isfinite(logits).all()
        last = logits[:, -1].float()
        rel = float((last_fwd - last).norm() / last.norm())
        tok = last.argmax(-1)[:, None]
        ticks = []
        for i in range(n_new):
            (logits, cache), dt = timed(lambda: model.decode_step(
                params, {"tokens": tok}, cache, S + i))
            ok &= torch.isfinite(logits).all()
            tok = logits[:, -1:].argmax(-1)
            ticks.append(dt)
    want = {n: 0 for n in launches}
    want["flash_attention_fwd"] = cfg.num_layers
    call = ((1, S, cfg.num_heads, cfg.hd), (1, S, cfg.kv_heads, cfg.hd),
            torch.bfloat16, True, None, None)
    if launches != want or _launches(torch) != want:
        raise AssertionError(f"6v forward launches {launches}, then "
                             f"{_launches(torch)}; expected {want}")
    if fw.calls != [call] * cfg.num_layers:
        raise AssertionError(f"6v K5 calls {sorted(set(fw.calls))}, "
                             f"expected {cfg.num_layers} x {call}")
    if not bool(ok) or rel > run["tol"]:
        raise AssertionError(f"6v: finite {bool(ok)}; forward vs prefill "
                             f"last logits {rel:.3g} of their norm > "
                             f"{run['tol']}")
    stats["image_text"] = {
        **run, "forward_ms": 1e3 * fwd_s, "prefill_ms": 1e3 * prefill_s,
        "decode_tick_ms_median": 1e3 * statistics.median(ticks),
        "tok_s": (1 + n_new) / (prefill_s + sum(ticks)),
        "forward_vs_prefill_rel_err": rel, "launches": launches,
        "flash_call": [list(call[0]), list(call[1]), "bfloat16",
                       *call[3:]]}
    stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  (b) {Np} patches + {Nt} text tokens: forward "
        f"{1e3 * fwd_s:.2f} ms with K5 {launches['flash_attention_fwd']} = "
        f"{cfg.num_layers} layers causal at {call[0]} under M-RoPE; prefill "
        f"{1e3 * prefill_s:.2f} ms, {n_new} decode steps at the global "
        f"index, tick median {1e3 * statistics.median(ticks):.2f} ms, "
        f"{stats['image_text']['tok_s']:.1f} tok/s; forward vs prefill last "
        f"logits {rel:.3g} of their norm (tol {run['tol']}); peak memory "
        f"{stats['max_memory_allocated_gb']:.2f} GB")
    with torch.no_grad():
        stats["profile"] = {
            "forward": profile_window(
                torch, "forward", lambda: model.forward(params, batch), 1),
            "decode tick": profile_window(
                torch, "decode tick", lambda: model.decode_step(
                    params, {"tokens": tok}, cache, S + n_new - 1), 1)}
    del params, lm, cache
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def blockwise_devices(torch):
    """Phase 7b (a): ``blockwise_attention`` at h2o-danube-1.8b's admit
    shape (B=1, S=8192, H=32, KVH=8, D=80, causal, window 4096), float32
    and bfloat16, on the card against ``naive_attention`` on the card, run
    one kv head (its 4 query heads) at a time to bound the S x S scores;
    3e-5 in float32 (``tests/test_flash_blockwise.py``), 2e-2 in bfloat16.
    Then timed per call (wall time: a call syncs once, for the block
    bounds) at that shape and at stablelm-3b's (S=2048, H=KVH=32, causal),
    beside one ``scaled_dot_product_attention`` call with the same mask
    (timed only; the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.nn.flash import (_pair_mask, blockwise_attention,
                                      naive_attention)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    shapes = {"h2o-danube-1.8b": (1, 8192, 32, 8, 80, 4096),
              "stablelm-3b": (1, 2048, 32, 32, 80, None)}
    out = {}
    for arch, (B, S, H, KVH, D, window) in shapes.items():
        G = H // KVH
        pos = torch.arange(S, device=dev).expand(B, S)
        kw = dict(q_pos=pos, kv_pos=pos, causal=True, window=window)
        for dtype, tol in ((torch.float32, 3e-5), (torch.bfloat16, 2e-2)):
            q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(B, S, KVH, D, generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            name = f"{arch}/{str(dtype).removeprefix('torch.')}"
            _, bp = blockwise_watch()
            with bp:
                got = blockwise_attention(q, k, v, **kw)
            worst = 0.0
            if arch == "h2o-danube-1.8b":
                for h in range(KVH):
                    heads = slice(h * G, (h + 1) * G)
                    want = naive_attention(q[:, :, heads], k[:, :, h:h + 1],
                                           v[:, :, h:h + 1], **kw)
                    torch.testing.assert_close(got[:, :, heads].float(),
                                               want.float(), rtol=tol,
                                               atol=tol)
                    worst = max(worst, float((got[:, :, heads].float()
                                              - want.float()).abs().max()))
            ms = wall_ms(torch, lambda: blockwise_attention(q, k, v, **kw))
            qt = q.transpose(1, 2)
            kt, vt = (x.transpose(1, 2).repeat_interleave(G, 1)
                      for x in (k, v))
            mask = _pair_mask(pos[0, :, None], pos[0, None, :], True,
                              window, None)
            lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), reps=10)
            out[name] = {"shape_bshkd": [B, S, H, KVH, D], "window": window,
                         "block_pairs": len(bp.calls), "ms": ms,
                         "sdpa_ms": lib_ms}
            if arch == "h2o-danube-1.8b":
                out[name]["max_abs_err_vs_naive"] = worst
            log(f"  blockwise {name} B,S,H,KVH,D={B, S, H, KVH, D} window "
                f"{window}: {len(bp.calls)} live block pairs, "
                + (f"max abs err vs naive {worst:.3g} (tol {tol}), "
                   if arch == "h2o-danube-1.8b" else "")
                + f"{ms:.2f} ms a call (wall), sdpa with the same mask "
                f"{lib_ms:.3f} ms")
            del q, k, v, got, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return out


HOTSWAP_LAYERS = 4  # qwen3-4b cut to 4 of 36 layers: 792,681,984 params
# phase 8a: rounds measured (counts zeroed before), then a profiled round
# after a warm-up one, then 6w's round: the session's RunSpec.rounds
LM_ROUNDS, LM_PROFILED, LM_SWAP_ROUNDS = 4, 2, 1


def _launches(torch):
    from repro_torch.kernels import kernels

    torch.cuda.synchronize()
    return {n: x.launches for n, x in kernels().items()}


def lm_training_path(torch):
    """Phase 8a: elastic LM training at full width through ``RunSpec`` /
    ``ElasticSession``: qwen3-4b at full width cut to 4 of 36 layers
    (792,681,984 params, the model 6w serves), float32 params and
    activations as ``train_lm_elastic`` sets them, drawn on the card from
    a seed; AdaHessian, DEAHES-O (dynamic weighting), k=2, τ=1, 128-token
    windows, batch 2, fused comm, a held-out eval every round. Counts
    zeroed just before 4 rounds and read just after: the batched
    AdaHessian step (K1) and the batched exchange (K2) once a round, the
    flash kernel (K5) 4 times an eval (one per layer; the eval runs under
    ``no_grad``, the local phase's ``vmap(jvp(grad))`` never reaches it),
    nothing else. Then one warm-up round and one ``torch.profiler`` round
    (device busy share, kernels a round). Returns the live session, which
    6w keeps training and saving."""
    import numpy as np

    from repro_torch.api.session import ElasticSession, RunSpec
    from repro_torch.configs.base import (ElasticConfig, OptimizerConfig,
                                          get_config)
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models.registry import build_model
    from repro_torch.nn.param import init_tree, param_count

    dev = torch.device("cuda")
    cfg = get_config("qwen3-4b").replace(num_layers=HOTSWAP_LAYERS,
                                         dtype="float32",
                                         param_dtype="float32")
    spec_tree = build_model(cfg).spec
    n_params = param_count(spec_tree)
    if n_params != 792_681_984:
        raise AssertionError(f"qwen3-4b at 4 layers has {n_params:,} params")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec = RunSpec(
        model_cfg=cfg, optimizer=OptimizerConfig(name="adahessian", lr=0.002),
        elastic=ElasticConfig(num_workers=2, tau=1, comm_mode="fused",
                              dynamic=True),
        rounds=LM_ROUNDS + LM_PROFILED + LM_SWAP_ROUNDS, seed=0,
        batch_size=2, seq_len=128, eval_every=1, device="cuda")
    params = init_tree(torch.Generator(dev).manual_seed(5), spec_tree, dev)
    sess = ElasticSession(spec, params=params)
    del params
    setup_s = time.perf_counter() - t0
    reset_launch_counts()
    records = sess.run(LM_ROUNDS)
    launches = _launches(torch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in launches}
    want.update(adahessian_update_batched=LM_ROUNDS,
                elastic_update_batched=LM_ROUNDS,
                flash_attention_fwd=LM_ROUNDS * HOTSWAP_LAYERS)
    if launches != want:
        raise AssertionError(f"LM training launches {launches}, expected "
                             f"{want}")
    losses = [r.loss for r in records] + [r.eval_loss for r in records]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"LM training: a non-finite loss {losses}")
    if not any(np.asarray(r.h2).any() for r in records):
        raise AssertionError("LM training: no worker reached the master")
    steady = records[1:]
    stats = {
        "arch": cfg.name, "layers": HOTSWAP_LAYERS, "params": n_params,
        "workers": 2, "tau": 1, "seq_len": 128, "batch": 2,
        "comm": "fused", "rounds": LM_ROUNDS, "setup_s": setup_s,
        "round_ms": statistics.median(r.round_ms for r in steady),
        "first_round_ms": records[0].round_ms,
        "dispatch_share": statistics.median(r.dispatch_ms / r.round_ms
                                            for r in steady),
        "peak_gb": peak_gb, "launches": launches,
        "worker_loss": [r.loss for r in records],
        "master_eval_loss": [r.eval_loss for r in records],
        "h2": [np.asarray(r.h2).tolist() for r in records]}
    stats["profiled_round"] = profile_window(
        torch, "LM round (qwen3-4b width, 4 layers, k=2)",
        lambda: sess.run(1), 1)
    log(f"  {n_params:,} params, float32, k=2, tau=1, fused; setup "
        f"{setup_s:.1f} s; round ms {stats['round_ms']:.1f} (median of "
        f"rounds 1-{LM_ROUNDS - 1}; round 0 {records[0].round_ms:.1f}), "
        f"dispatch share {stats['dispatch_share']:.3f}; peak "
        f"{peak_gb:.2f} GB; launches {launches}; worker loss "
        f"{records[-1].loss:.4f}, master eval loss "
        f"{records[-1].eval_loss:.4f}")
    return sess, stats


def train_lm_elastic_path(torch):
    """Phase 8b: ``repro_torch.examples.train_lm_elastic --preset 100m``
    (d_model 768, 12 layers, 12 heads of 64, 512-token windows, batch 16:
    the reference's preset for real hardware) at k=4, τ=2 for 3 rounds,
    sequential comm (the example's default), a held-out eval every round,
    one worker per vmapped local-phase call (``--worker-chunk 1``: one
    worker's ``vmap(jvp(grad))`` at 16 x 512 tokens keeps most of the
    card's 80 GB alive, so two at once do not fit).
    Counts zeroed just before and read just after: K1 once a τ-step, the
    one-worker exchange (K3) once a worker a round, K5 12 times an eval
    (head_dim 64 at 512 tokens is the flash kernel's shape), nothing
    else."""
    from repro_torch.examples import train_lm_elastic
    from repro_torch.kernels import reset_launch_counts

    rounds, k, tau, layers, chunk = 3, 4, 2, 12, 1
    # the earlier phases' engines sit in reference cycles (their patched
    # hooks close over them) until a collection; 8b needs the whole card
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        sess, records = train_lm_elastic.main([
            "--preset", "100m", "--workers", str(k), "--tau", str(tau),
            "--rounds", str(rounds), "--eval-every", "1",
            "--worker-chunk", str(chunk)])
    launches = _launches(torch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in out.getvalue().splitlines():
        log(f"  | {line}")
    want = {n: 0 for n in launches}
    want.update(adahessian_update_batched=rounds * tau,
                elastic_update=rounds * k,
                flash_attention_fwd=rounds * layers)
    if launches != want:
        raise AssertionError(f"train_lm_elastic launches {launches}, "
                             f"expected {want}")
    losses = [r.loss for r in records] + [r.eval_loss for r in records]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_lm_elastic: a non-finite loss {losses}")
    stats = {"preset": "100m", "params": sess.layout.n, "workers": k,
             "tau": tau, "rounds": rounds, "comm": sess.ecfg.comm_mode,
             "worker_chunk": chunk, "held_before_gb": held_gb,
             "round_ms": statistics.median(r.round_ms for r in records[1:]),
             "first_round_ms": records[0].round_ms,
             "dispatch_share": statistics.median(
                 r.dispatch_ms / r.round_ms for r in records[1:]),
             "peak_gb": peak_gb, "launches": launches,
             "worker_loss": [r.loss for r in records],
             "master_eval_loss": [r.eval_loss for r in records]}
    log(f"  {sess.layout.n:,} params; round ms {stats['round_ms']:.1f} "
        f"(median of rounds 1-{rounds - 1}; round 0 "
        f"{records[0].round_ms:.1f}); peak {peak_gb:.2f} GB ({held_gb:.2f} "
        f"GB held before it); launches {launches}")
    del sess
    torch.cuda.empty_cache()
    return stats


# phase 8c: (arch, config changes, comm, tokens), τ=2; phase 8e: the MoE
# family, τ=1
LM_PARITY = (("stablelm-3b", {}, "fused", 16),
             ("qwen3-4b", {"head_dim": 64}, "sequential", 128))
MOE_LM_PARITY = (("moonshot-v1-16b-a3b", {}, "fused", 128),
                 ("mixtral-8x22b", {}, "sequential", 128))


def lm_device_parity(torch, cases=LM_PARITY, tau=2):
    """Phase 8c (and 8e): LM training on the card and on the CPU (plain
    versions) from the same params and probes, 3 rounds, AdaHessian,
    DEAHES-O (dynamic weighting, overlap), k=2. 8c, τ=2: stablelm-3b SMOKE
    with fused comm, qwen3-4b SMOKE with head_dim 64 at 128 tokens with
    sequential comm (its eval is the flash kernel's shape: K5 on the card,
    the plain version on the CPU). 8e, τ=1, 128 tokens: moonshot-smoke
    (fused) and mixtral-smoke (sequential), the loss with the router aux,
    the capacity dispatch under the local phase's ``vmap(jvp(grad))``.
    All in float32 (the CPU tests' parity configs). Master and workers
    agree per leaf (``_leaf_parity``: norm-wise within 1e-3, elementwise
    within rtol 1e-4 plus 2% of the leaf's scale; the ROADMAP's rule),
    round losses and the held-out eval loss at rtol 1e-4. Launches: K1
    once a τ-step, K2 once a round (fused) or K3 once a worker a round
    (sequential), K5 once a layer an eval where the eval is its shape."""
    import numpy as np

    from repro_torch.api.session import ElasticSession, RunSpec
    from repro_torch.configs.base import (ElasticConfig, OptimizerConfig,
                                          get_config)
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models.registry import build_model
    from repro_torch.nn.param import init_tree

    out = {}
    for arch, extra, comm, seq in cases:
        cfg = get_config(arch, smoke=True).replace(
            dtype="float32", param_dtype="float32", **extra)
        spec_tree = build_model(cfg).spec
        params = init_tree(torch.Generator().manual_seed(7), spec_tree)

        def probes(device, n):
            def fn(r, t, i):
                z = np.random.default_rng([13, r, t, i]).integers(
                    0, 2, (1, n)).astype(np.float32) * 2 - 1
                return torch.from_numpy(z).to(device)
            return fn

        runs = {}
        for device in ("cuda", "cpu"):
            spec = RunSpec(
                model_cfg=cfg, optimizer=OptimizerConfig(name="adahessian"),
                elastic=ElasticConfig(num_workers=2, tau=tau, comm_mode=comm),
                rounds=3, batch_size=2, seq_len=seq, n_tokens=4000,
                eval_every=1, device=device)
            sess = ElasticSession(spec, params=params)
            sess.trainer.probe_fn = probes(device, sess.layout.n)
            reset_launch_counts()
            records = sess.run()
            runs[device] = (records, sess.state["master"].cpu().double(),
                            sess.state["workers"].cpu().double(),
                            _launches(torch), sess.layout)
        (rc, mc, wc, lc, layout), (rp, mp, wp, _, _) = (runs["cuda"],
                                                        runs["cpu"])
        norm, worst = _leaf_parity(torch, layout, mc, mp,
                                   f"{arch} master", 1e-3)
        for i in range(wc.shape[0]):
            n_i, w_i = _leaf_parity(torch, layout, wc[i], wp[i],
                                    f"{arch} worker {i}", 1e-3)
            norm, worst = max(norm, n_i), max(worst, w_i)
        for a, b in zip(rc, rp):
            for key in ("loss", "eval_loss"):
                x, y = getattr(a, key), getattr(b, key)
                if not math.isclose(x, y, rel_tol=1e-4):
                    raise AssertionError(f"{arch} round {a.round} {key}: "
                                         f"card {x} vs CPU {y}")
        want = {n: 0 for n in lc}
        want["adahessian_update_batched"] = 3 * tau
        want["elastic_update_batched" if comm == "fused"
             else "elastic_update"] = 3 if comm == "fused" else 3 * 2
        if seq % 128 == 0 and cfg.hd in (64, 128):
            want["flash_attention_fwd"] = 3 * cfg.num_layers
        if lc != want:
            raise AssertionError(f"{arch} card launches {lc}, expected "
                                 f"{want}")
        log(f"  {cfg.name} {comm}, {seq} tokens: card vs CPU master and "
            f"workers worst leaf norm-wise {norm:.3g}, max abs {worst:.3g}; "
            f"eval loss {rc[-1].eval_loss:.6f} / {rp[-1].eval_loss:.6f}; "
            f"card launches {lc}")
        out[cfg.name] = {"comm": comm, "seq_len": seq, "tau": tau,
                         "worst_norm_rel": norm, "max_abs": worst,
                         "losses_card": [r.loss for r in rc],
                         "losses_cpu": [r.loss for r in rp],
                         "launches": lc}
    return out


def lm_gradients(torch):
    """Phase 8d: the flash kernel refuses gradients, and LM training's
    gradients on the card are the CPU's. (a) ``flash_attention_bshd`` on
    CUDA tensors raises under autograd (an input that requires grad) and
    under ``torch.func.grad``, launching nothing. (b) qwen3-4b SMOKE with
    head_dim 64 at 128 tokens, float32 (a flash shape):
    ``DecoderLM.loss(...).backward()`` on the card gives every leaf a
    gradient, equal to the CPU's within 1e-3 of the leaf's gradient scale
    (phase 7's float32 tolerance), with no K5 launch during forward or
    backward; the same loss under ``no_grad`` launches K5 once a layer and
    agrees."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fla
    from repro_torch.models.registry import build_model
    from repro_torch.nn.param import init_tree, tree_from_leaves, tree_leaves

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    q = torch.randn(1, 128, 4, 64, generator=gen, device=dev)
    kv = torch.randn(1, 128, 2, 64, generator=gen, device=dev)
    reset_launch_counts()
    refused = []
    for how, call in (
            ("requires_grad", lambda: fla.flash_attention_bshd(
                q.clone().requires_grad_(), kv, kv)),
            ("torch.func.grad", lambda: torch.func.grad(
                lambda x: fla.flash_attention_bshd(x, kv, kv).sum())(q))):
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            refused.append(how)
        else:
            raise AssertionError(f"flash_attention_bshd ran under {how}")
    if _launches(torch)["flash_attention_fwd"]:
        raise AssertionError("a refused flash call launched the kernel")

    cfg = get_config("qwen3-4b", smoke=True).replace(
        head_dim=64, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    cpu = init_tree(torch.Generator().manual_seed(9), model.spec)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 129))
    grads, losses = {}, {}
    for device in ("cpu", "cuda"):
        params = tree_from_leaves((p, t.detach().to(device).requires_grad_())
                                  for p, t in tree_leaves(cpu))
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=device),
                 "targets": torch.as_tensor(toks[:, 1:], device=device)}
        reset_launch_counts()
        loss = model.loss(params, batch)[0]
        loss.backward()
        losses[device] = float(loss.detach())
        if device == "cuda":
            if _launches(torch)["flash_attention_fwd"]:
                raise AssertionError("K5 launched under autograd")
            with torch.no_grad():
                nograd = float(model.loss(params, batch)[0])
            if _launches(torch)["flash_attention_fwd"] != cfg.num_layers:
                raise AssertionError("the no_grad loss did not run K5 once "
                                     "a layer")
            if not math.isclose(nograd, losses[device], rel_tol=1e-4):
                raise AssertionError(f"no_grad loss {nograd} vs "
                                     f"{losses[device]}")
        grads[device] = {p: t.grad for p, t in tree_leaves(params)}
    worst = 0.0
    for path, want in grads["cpu"].items():
        got = grads["cuda"][path]
        if got is None or want is None:
            raise AssertionError(f"leaf {path} got no gradient")
        got = got.cpu()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or err > 1e-3 * scale:
            raise AssertionError(f"grad {path}: card vs CPU max abs {err:.3g}"
                                 f" > 1e-3 x {scale:.3g}")
        worst = max(worst, err / max(scale, 1e-30))
    log(f"  flash refused under {refused} with 0 launches; {cfg.name} "
        f"hd 64, 128 tokens: {len(grads['cpu'])} leaves, every one a "
        f"gradient, card vs CPU worst {worst:.3g} of the leaf's scale, "
        f"loss {losses['cuda']:.6f} / {losses['cpu']:.6f}; 0 K5 launches "
        f"under autograd, {cfg.num_layers} under no_grad")
    return {"refused": refused, "leaves": len(grads["cpu"]),
            "worst_grad_rel": worst, "loss_card": losses["cuda"],
            "loss_cpu": losses["cpu"]}


def hotswap_path(torch, sess):
    """Phase 6w: checkpoint hot-swap from the live training session of
    phase 8a into the continuous engine: qwen3-4b at full width cut to 4
    layers, the engine in bf16 (a checkpoint stores the float32 master, 3.2
    GB here, 16 GB at full depth). The session saves a baseline master,
    then a ``CheckpointWatcher`` watches the directory from the engine,
    under a ``Scheduler`` (capacity 4, ``poll_every`` 8) over 6 requests
    (prompts 256 and 512, 32 new tokens); after tick 10 the session
    trains one more round (K1, K2 once each, its eval K5 4 times) and
    saves its next master into the watched directory. Checks: one swap,
    applied at tick 16 (the first poll after the save; every poll on a
    multiple of 8); the engine's params are the session's master cast to
    the engine's dtypes, leaf for leaf; the requests in flight keep their
    pre-swap tokens and drain to 32; after the run a prompt decoded by the
    swapped engine and by a fresh engine restored from the same checkpoint
    gives the same tokens, bit for bit; flash launches admits x 4 plus the
    eval's 4; a checkpoint of another arch is journalled once and
    skipped."""
    import dataclasses

    from repro_torch.checkpoint import checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models.registry import build_model
    from repro_torch.nn.param import init_tree, param_count, tree_leaves
    from repro_torch.serving import (CheckpointWatcher, ContinuousEngine,
                                     Scheduler)
    from repro_torch.serving.traffic import TrafficConfig, synthetic_traffic

    dev = torch.device("cuda")
    cfg = get_config("qwen3-4b").replace(num_layers=HOTSWAP_LAYERS)
    model = build_model(cfg)
    n_params = param_count(model.spec)
    if n_params != 792_681_984 or sess.model_cfg.name != cfg.name:
        raise AssertionError(f"qwen3-4b at 4 layers has {n_params:,} params"
                             f", the session trains {sess.model_cfg.name}")
    gen = torch.Generator(dev).manual_seed(3)
    params = init_tree(gen, model.spec, dev)
    stats = {"layers": HOTSWAP_LAYERS, "params": n_params}
    timings = {"restore_s": [], "flip_s": []}
    restore = checkpoint.restore

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = restore(*a, **kw)
        torch.cuda.synchronize()
        timings["restore_s"].append(time.perf_counter() - t0)
        return out

    capacity, prompt_len, steps, n_req = 4, 512, 32, 6
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "master")
        t0 = time.perf_counter()
        sess.save(ck)
        stats["save_s"] = time.perf_counter() - t0
        stats["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        lm = WatchedLM(torch, model)
        shape = dict(capacity=capacity, max_len=prompt_len + steps + 1,
                     prefill_len=prompt_len)
        engine = ContinuousEngine(lm, params, **shape)
        watcher = CheckpointWatcher(engine, ck)
        sched = Scheduler(engine, watcher=watcher, poll_every=8)
        flip = engine.swap_params

        def timed_flip(new):
            t0 = time.perf_counter()
            flip(new)
            timings["flip_s"].append(time.perf_counter() - t0)

        engine.swap_params = timed_flip
        polls, pre_swap, tick_s = [], {}, []
        poll = watcher.poll

        def watched_poll():
            polls.append(engine.ticks)
            if not watcher.log:  # in-flight tokens just before any swap
                pre_swap.clear()
                pre_swap.update({engine._slots[s].rid:
                                 list(engine._slots[s].tokens)
                                 for s in engine.active_slots()})
            return poll()

        watcher.poll = watched_poll
        tick = sched.tick

        def timed_tick():
            t0 = time.perf_counter()
            out = tick()
            tick_s.append((engine.ticks, time.perf_counter() - t0,
                           bool(polls) and polls[-1] == engine.ticks))
            if engine.ticks == 10 and "next_save_s" not in stats:
                t1 = time.perf_counter()
                rec = sess.run(1)[0]
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                sess.save(ck)
                stats.update(train_round_s=t2 - t1,
                             next_save_s=time.perf_counter() - t2,
                             session_round=rec.round,
                             session_eval_loss=rec.eval_loss)
            return out

        sched.tick = timed_tick
        # every request arrives at t=0, so 4 are in flight at tick 16
        trace = [dataclasses.replace(r, arrival=0.0) for r in
                 synthetic_traffic(TrafficConfig(
                     num_requests=n_req, prompt_lens=(256, 512),
                     max_new=steps, vocab_size=cfg.vocab_size,
                     seed=0))]
        checkpoint.restore = timed_restore
        reset_launch_counts()
        try:
            results = sched.run(trace)
        finally:
            checkpoint.restore = restore
            watcher.poll = poll
        launches = _launches(torch)
        admits = len(lm.times["prefill"])
        want = {n: 0 for n in launches}
        want.update(flash_attention_fwd=(admits + 1) * HOTSWAP_LAYERS,
                    adahessian_update_batched=1, elastic_update_batched=1)
        if launches != want:
            raise AssertionError(f"hot-swap launches {launches}, "
                                 f"expected {want}")
        applied = [e for e in watcher.log if e.applied]
        if (len(watcher.log) != 1 or len(applied) != 1 or engine.swaps != 1
                or applied[0].tick != 16 or applied[0].rounds != sess.round):
            raise AssertionError(f"swap journal {watcher.log}, "
                                 f"{engine.swaps} swaps")
        if any(t % 8 for t in polls) or polls[:2] != [8, 16]:
            raise AssertionError(f"polls at ticks {polls}")
        if not bool(lm.finite):
            raise AssertionError("a non-finite logit in the hot-swap run")
        by_rid = {r.rid: r for r in results}
        if len(by_rid) != n_req or any(
                r.num_tokens != steps for r in results):
            raise AssertionError("a request was dropped or cut short")
        if not pre_swap:
            raise AssertionError("no request was in flight at the swap")
        for rid, toks in pre_swap.items():
            if by_rid[rid].tokens[:len(toks)].tolist() != toks:
                raise AssertionError(f"request {rid}'s pre-swap tokens "
                                     "changed")
        for (path, a), (_, b) in zip(tree_leaves(engine.params),
                                     tree_leaves(sess.master_tree())):
            if not torch.equal(a, b.to(a.dtype)):
                raise AssertionError(f"swapped leaf {path} != the session's "
                                     "master")

        fresh_params, _ = checkpoint.restore(ck, like=params)
        fresh = ContinuousEngine(model, fresh_params, **shape)
        prompt = trace[0].prompt
        outs = []
        for eng in (engine, fresh):
            eng.admit(prompt, max_new=steps, rid=99)
            done = []
            while eng.num_active:
                done += eng.step()
            outs.append(done[-1].tokens.tolist())
        if outs[0] != outs[1]:
            raise AssertionError("post-swap tokens differ from a fresh "
                                 "engine restored from the checkpoint")

        checkpoint.save(ck, {"w": torch.zeros(3)},
                        metadata={"arch": "stablelm-3b", "rounds": 2})
        if watcher.poll() or watcher.poll() or len(watcher.log) != 2:
            raise AssertionError(f"arch mismatch not skipped once: "
                                 f"{watcher.log}")
        if "arch mismatch" not in watcher.log[-1].note or engine.swaps != 1:
            raise AssertionError(f"arch mismatch journal {watcher.log[-1]}")
    swap_tick = [s for t, s, p in tick_s if t == applied[0].tick and p]
    plain_ticks = [s for t, s, p in tick_s if not p and t != 10]
    stats.update({
        "swaps_applied": watcher.swaps_applied, "swap_tick": 16,
        "swapped_rounds": applied[0].rounds,
        "polls": polls, "admits": admits,
        "flash_launches": launches["flash_attention_fwd"],
        "launches": launches,
        "in_flight_at_swap": sorted(pre_swap),
        "standby_restore_ms": 1e3 * timings["restore_s"][0],
        "flip_ms": 1e3 * timings["flip_s"][0],
        "polling_tick_ms": 1e3 * swap_tick[0],
        "median_tick_ms": 1e3 * statistics.median(plain_ticks),
        "post_swap_tokens_match_fresh": True,
        "arch_mismatch_journalled": watcher.log[-1].note})
    log(f"  {n_params:,} params ({HOTSWAP_LAYERS} layers); checkpoint "
        f"{stats['checkpoint_bytes']:,} B, session save {stats['save_s']:.2f}"
        f" s; at tick 10 the session trained round {stats['session_round']}"
        f" ({stats['train_round_s']:.2f} s) and saved "
        f"({stats['next_save_s']:.2f} s); 1 swap at tick 16 (polls {polls}),"
        f" master of round {applied[0].rounds}, requests {sorted(pre_swap)} "
        f"in flight kept their tokens; standby restore "
        f"{stats['standby_restore_ms']:.1f} ms, flip {stats['flip_ms']:.3f} "
        f"ms; the polling tick {stats['polling_tick_ms']:.1f} ms beside a "
        f"median tick {stats['median_tick_ms']:.2f} ms; launches {launches}"
        f" ({admits} admits x {HOTSWAP_LAYERS} + the eval's "
        f"{HOTSWAP_LAYERS} flash); post-swap tokens = fresh engine's; arch "
        "mismatch journalled once")
    del params, fresh_params, engine, fresh, lm
    torch.cuda.empty_cache()
    return launches, stats


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

    if sys.argv[1:2] == ["--sharded-rank"]:  # one rank of phase 5p
        rank, world, port = (int(x) for x in sys.argv[2:5])
        resolve_device("cuda")
        sharded_rank(torch, rank, world, port, sys.argv[5])
        return 0

    t_start = time.perf_counter()
    resolve_device("cuda")  # TF32 off for matmuls and cuDNN
    smi = nvidia_smi_line()
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    card, rates = card_rates(smi.split(",")[0])
    log(f"    rates of record for {card}: {rates[0] / 1e12:.2f} TB/s, "
        f"{rates[1] / 1e12:.0f} TFLOP/s f32, {rates[2] / 1e12:.0f} TFLOP/s "
        f"dense bf16, {rates[3] / 1e12:.1f} TFLOP/s dense TF32")

    t0 = time.perf_counter()
    libs = build()
    for kernel in kernels().values():
        kernel.load()
    log(f"[2] built {sorted(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    hgmma, hgmma_tf32 = hgmma_count(libs["flash_attention.cu"])
    log(f"    flash_attention library SASS: {hgmma} HGMMA instructions "
        f"(cuobjdump -sass | grep -c HGMMA), {hgmma_tf32} of them TF32")
    if hgmma == hgmma_tf32 or hgmma_tf32 == 0:
        raise AssertionError("the flash-attention library lacks bf16 or TF32 "
                             "HGMMA: one of its kernels does not use the "
                             "tensor cores")

    log(f"[3] kernels vs plain versions at k={K}, n={N}")
    table = check_kernels(torch, rates)
    log(f"[3b] flash attention vs plain version, {len(FLASH_SWEEP)} shapes")
    table.append(check_flash(torch, rates))
    table[-1]["hgmma_count"] = hgmma
    table[-1]["tf32_hgmma_count"] = hgmma_tf32

    log("[4] §VI path: paper_repro.run_one on the card")
    totals, _ = main_path(torch)
    log(f"    launches on the §VI path: {totals}")

    log("[5] card vs CPU, DEAHES-O, 2 rounds, carried params and probes")
    device_parity(torch)

    log("[5b] training CLI at full width: launch/train.py main")
    cli, plain_counts = train_cli(torch)
    log("[5c] card vs CPU, plain control, 3 steps, carried params and probes")
    cli["plain_card_vs_cpu"] = plain_device_parity(torch)

    log("[5d] membership at full width: launch/train.py main, capacity 8")
    membership = membership_cli(torch)
    log("[5e] closed-loop control at full width: --controller rules")
    control = control_cli(torch)
    log("[5f] card vs CPU, membership: scale-up 4 -> 6, 4 rounds")
    membership["card_vs_cpu"] = membership_device_parity(torch)
    log("[5g] §VI grid (2 jobs on the card) and report")
    membership["grid"] = grid_report(torch)
    log("[5h] hierarchy at full width: launch/train.py main, 16 slots in "
        "4 racks, global sync every 2 rounds")
    hierarchy = hierarchy_cli(torch)
    log("[5p] sharded placement at full width: launch/train.py main at "
        "world size 1, then two ranks on the card")
    t0 = time.perf_counter()
    sharded = sharded_cli(torch)
    sharded["phase_s"] = time.perf_counter() - t0
    log(f"    phase 5p took {sharded['phase_s']:.1f} s")

    log("[6] serving path: qwen3-4b at full width through launch/serve.py")
    serve_counts, serve_stats = serving_path(torch)
    for entry in table:
        name = entry["name"]
        entry["launches"] = (
            serve_counts if name == "flash_attention_fwd"
            else plain_counts if name == "adahessian_update_flat"
            else totals)[name]
        if name in hierarchy["launches"]:
            entry["hierarchy_launches"] = hierarchy["launches"][name]
        if name in sharded["launches_per_rank"]["flat"]:
            entry["sharded_launches_per_rank"] = {
                kind: counts[name] for kind, counts in
                sharded["launches_per_rank"].items()}

    family = {}
    for phase, arch in (("6s", "stablelm-3b"), ("6d", "h2o-danube-1.8b")):
        log(f"[{phase}] {arch} at full size through launch/serve.py "
            "(blockwise prefill)")
        t0 = time.perf_counter()
        family[arch] = dense_family_path(torch, arch)
        family[arch]["phase_s"] = time.perf_counter() - t0
    moe = {}
    for phase, arch in (("6m", "moonshot-v1-16b-a3b"),
                        ("6x", "mixtral-8x22b"),
                        ("6x", "llama4-scout-17b-a16e")):
        log(f"[{phase}] {arch} "
            + ("at full size" if phase == "6m" else
               "at full width, 2 layers")
            + " through launch/serve.py (K5 on every admit)")
        t0 = time.perf_counter()
        moe[arch] = moe_serving_path(torch, arch)
        moe[arch]["phase_s"] = time.perf_counter() - t0
    families = {}
    log("[6e] seamless-m4t-large-v2 at full size through "
        "ServeEngine.generate with src frames (K5 non-causal in the "
        "encoder)")
    t0 = time.perf_counter()
    families["6e"] = encdec_serving_path(torch)
    families["6e"]["phase_s"] = time.perf_counter() - t0
    log("[6v] qwen2-vl-7b at full size: launch/serve.py static, then one "
        "image-and-text request (K5 under M-RoPE)")
    t0 = time.perf_counter()
    families["6v"] = vlm_serving_path(torch)
    families["6v"]["phase_s"] = time.perf_counter() - t0
    lm = {}
    log(f"[8a] LM training at full width: qwen3-4b width, {HOTSWAP_LAYERS} "
        "layers, float32, ElasticSession on the card")
    t0 = time.perf_counter()
    sess, lm["8a"] = lm_training_path(torch)
    lm["8a"]["phase_s"] = time.perf_counter() - t0
    log(f"[6w] hot-swap: qwen3-4b width, {HOTSWAP_LAYERS} layers, "
        "CheckpointWatcher on the continuous engine, watching the live "
        "session of 8a")
    t0 = time.perf_counter()
    swap_counts, hotswap = hotswap_path(torch, sess)
    hotswap["phase_s"] = time.perf_counter() - t0
    del sess  # 6w's patched scheduler hooks hold it in a reference cycle
    gc.collect()
    torch.cuda.empty_cache()

    log("[7] serving card vs CPU: qwen3-4b width, 2 layers, float32")
    serve_stats["card_vs_cpu_rel_err"] = serving_device_parity(torch)[0]
    log("[7b] blockwise attention on the card vs naive; stablelm-3b and "
        "h2o-danube-1.8b card vs CPU at 1024 tokens")
    t0 = time.perf_counter()
    family["blockwise"] = blockwise_devices(torch)
    for arch in ("stablelm-3b", "h2o-danube-1.8b"):
        family[arch]["card_vs_cpu_rel_err"] = serving_device_parity(
            torch, arch, 1024)[0]
    family["phase_7b_s"] = time.perf_counter() - t0
    log("[7m] serving card vs CPU: moonshot-v1-16b-a3b width, 2 layers (1 "
        "dense + 1 MoE), float32")
    t0 = time.perf_counter()
    rel, moe["7m_launches"] = serving_device_parity(
        torch, "moonshot-v1-16b-a3b", 512)
    moe["moonshot-v1-16b-a3b"]["card_vs_cpu_rel_err"] = rel
    moe["phase_7m_s"] = time.perf_counter() - t0
    for phase, arch, S in (("7e", "seamless-m4t-large-v2", 128),
                           ("7v", "qwen2-vl-7b", 256)):
        log(f"[{phase}] serving card vs CPU: {arch} width, "
            f"{FAMILY_PARITY[arch]}, float32, {S} inputs")
        t0 = time.perf_counter()
        rel, launches = serving_device_parity(torch, arch, S)
        families[phase] = {"arch": arch, "inputs": S,
                           "cut": FAMILY_PARITY[arch],
                           "card_vs_cpu_rel_err": rel, "launches": launches,
                           "phase_s": time.perf_counter() - t0}

    log("[8b] train_lm_elastic --preset 100m, k=4, tau=2, 3 rounds")
    t0 = time.perf_counter()
    lm["8b"] = train_lm_elastic_path(torch)
    lm["8b"]["phase_s"] = time.perf_counter() - t0
    log("[8c] LM training card vs CPU at SMOKE, carried params and probes")
    t0 = time.perf_counter()
    lm["8c"] = lm_device_parity(torch)
    lm["8c"]["phase_s"] = time.perf_counter() - t0
    log("[8d] gradients: flash refuses them; DecoderLM.loss backward card "
        "vs CPU")
    t0 = time.perf_counter()
    lm["8d"] = lm_gradients(torch)
    lm["8d"]["phase_s"] = time.perf_counter() - t0
    log("[8e] MoE LM training card vs CPU at SMOKE, carried params and "
        "probes")
    t0 = time.perf_counter()
    lm["8e"] = lm_device_parity(torch, MOE_LM_PARITY, tau=1)
    lm["8e"]["phase_s"] = time.perf_counter() - t0
    for entry in table:
        name = entry["name"]
        entry["hotswap_launches"] = swap_counts[name]
        entry["lm_training_launches"] = {
            "8a": lm["8a"]["launches"][name], "8b": lm["8b"]["launches"][name],
            **{f"{phase} {arch}": run["launches"][name]
               for phase in ("8c", "8e")
               for arch, run in lm[phase].items()
               if isinstance(run, dict)}}
        entry["moe_launches"] = {
            **{f"{'6m' if arch.startswith('moonshot') else '6x'} {arch}":
               moe[arch]["launches"][name] for arch in MOE_SERVE},
            "7m": moe["7m_launches"][name]}
        entry["family_launches"] = {
            "6e": families["6e"]["launches"][name],
            "6v": families["6v"]["image_text"]["launches"][name],
            **{phase: families[phase]["launches"][name]
               for phase in ("7e", "7v")}}

    log(f"[9] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"train_cli": cli}))
    print(json.dumps({"serving": serve_stats}))
    print(json.dumps({"membership": membership}))
    print(json.dumps({"control": control}))
    print(json.dumps({"hierarchy": hierarchy}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"dense_family": family}))
    print(json.dumps({"hotswap": hotswap}))
    print(json.dumps({"lm_training": lm}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"families": families}))
    print(json.dumps({"kernels": table}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
