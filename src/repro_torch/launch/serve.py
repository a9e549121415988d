"""Serving launcher: static reference batches or continuous batching.

The port of ``repro.launch.serve``, with the same flags plus ``--device``
(default ``cuda``; ``--device cpu`` runs the plain PyTorch versions):

- **static** (default): one fixed batch through ``ServeEngine.generate``,
  two timed trials. Throughput counts real generated tokens: with
  ``--eos-id`` set, a row's EOS-pinned padding is excluded.
- **continuous** (``--traffic N``): N synthetic bursty requests replayed
  through ``Scheduler`` + ``ContinuousEngine`` on the virtual clock,
  reporting req/s, tok/s, time to first token and latency p50/p99.

Weights are drawn from a seed on the serving device (``--seed``);
``--restore`` and ``--watch`` need the port's checkpoint slice and raise.

    python -m repro_torch.launch.serve --arch qwen3-4b --full --traffic 16 \\
        --prompt-len 512 --steps 64
    python -m repro_torch.launch.serve --device cpu --traffic 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.nn.param import init_tree, param_count
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.traffic import TrafficConfig, synthetic_traffic


def generated_tokens(out: np.ndarray, eos_id=None) -> int:
    """Real generated-token count for a ``ServeEngine.generate`` output:
    positions after a row's first EOS are pinned padding, not throughput."""
    if eos_id is None:
        return int(out.size)
    total = 0
    for row in np.asarray(out):
        hits = np.flatnonzero(row == eos_id)
        total += int(hits[0]) + 1 if hits.size else row.size
    return total


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def serve_static(model, params, args, vocab_size: int, device):
    """Two timed ``generate`` trials; returns the last trial's tok/s."""
    engine = ServeEngine(model, params,
                         max_len=args.prompt_len + args.steps + 1)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab_size,
                           (args.batch, args.prompt_len)).astype("int32")
    for trial in range(2):
        _sync(device)
        t0 = time.perf_counter()
        out = engine.generate(prompts, steps=args.steps,
                              eos_id=args.eos_id)
        dt = time.perf_counter() - t0
        toks = generated_tokens(out, args.eos_id)
        label = " (warm-up)" if trial == 0 else ""
        print(f"trial {trial}{label}: {toks} tokens in {dt:.3f}s "
              f"({toks / dt:.1f} tok/s)")
    return toks / dt


def serve_continuous(model, params, args, vocab_size: int):
    """Replay a synthetic trace; returns (scheduler, results)."""
    engine = ContinuousEngine(
        model, params, capacity=args.capacity,
        max_len=args.prompt_len + args.steps + 1,
        prefill_len=args.prompt_len, eos_id=args.eos_id)
    sched = Scheduler(engine, poll_every=args.poll_every)
    trace = synthetic_traffic(TrafficConfig(
        num_requests=args.traffic,
        prompt_lens=tuple(sorted({max(1, args.prompt_len // 2),
                                  args.prompt_len})),
        max_new=args.steps, vocab_size=vocab_size,
        eos_id=args.eos_id, seed=0))
    results = sched.run(trace)
    served = [r for r in results if r.reason != "rejected"]
    lat = np.array([r.latency for r in served]) if served else np.zeros(1)
    ttft = np.array([r.ttft for r in served]) if served else np.zeros(1)
    toks = sum(r.num_tokens for r in served)
    span = max(sched.vnow, 1e-9)
    print(f"served {len(served)}/{len(results)} requests, {toks} tokens "
          f"over {span:.3f}s virtual ({len(served) / span:.2f} req/s, "
          f"{toks / span:.1f} tok/s)")
    print(f"ttft p50 {np.percentile(ttft, 50) * 1e3:.1f}ms "
          f"p99 {np.percentile(ttft, 99) * 1e3:.1f}ms; "
          f"latency p50 {np.percentile(lat, 50) * 1e3:.1f}ms "
          f"p99 {np.percentile(lat, 99) * 1e3:.1f}ms")
    return sched, results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--restore", default=None)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="token id that ends a generation (static mode "
                         "pins finished rows; continuous mode frees the "
                         "slot)")
    ap.add_argument("--capacity", type=int, default=8,
                    help="continuous mode: request-slot pool size")
    ap.add_argument("--traffic", type=int, default=0, metavar="N",
                    help="serve N synthetic bursty requests through the "
                         "continuous engine (0 = static reference mode)")
    ap.add_argument("--watch", default=None, metavar="DIR",
                    help="continuous mode: hot-swap params from new "
                         "checkpoints appearing in DIR")
    ap.add_argument("--poll-every", type=int, default=8,
                    help="decode ticks between --watch polls")
    args = ap.parse_args(argv)
    for flag in ("restore", "watch"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} needs checkpoints, which are not ported to "
                "PyTorch yet (checkpoint/checkpoint.py and "
                "serving/hotswap.py wait for the checkpoint slice)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = init_tree(torch.Generator(device).manual_seed(args.seed),
                       model.spec, device)
    print(f"serving {cfg.name}: {param_count(model.spec):,} params on "
          f"{device}")
    if args.traffic > 0:
        serve_continuous(model, params, args, cfg.vocab_size)
    else:
        serve_static(model, params, args, cfg.vocab_size, device)


if __name__ == "__main__":
    main()
