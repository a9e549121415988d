"""Serve a small model with batched requests: prefill + greedy decode over a
KV cache (the port of the reference's ``examples/serve_batch.py``). The
SMOKE variant of ``--arch`` with random weights from a seed, two
``ServeEngine.generate`` calls of one batch; runs on the card by default:

    PYTHONPATH=src python -m repro_torch.examples.serve_batch --arch qwen3-4b
    PYTHONPATH=src python -m repro_torch.examples.serve_batch \\
        --arch qwen2-vl-7b --device cpu

A VLM (qwen2-vl-7b) serves text-only prompts, as the reference's example
does. An encoder-decoder (seamless-m4t-large-v2) needs source frames,
which this example does not make: it raises naming ``src`` (the
reference's fails with ``KeyError: 'src'``); serve it through
``ServeEngine.generate(..., extra_batch={"src": ...})``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.nn.param import init_tree, param_count
from repro_torch.serving.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="token id that finishes a row early (finished "
                         "rows are EOS-pinned; the loop short-circuits "
                         "once every row is done)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)  # the reduced family variant
    model = build_model(cfg)
    params = init_tree(torch.Generator(device).manual_seed(0), model.spec,
                       device)
    print(f"{cfg.name}: {param_count(model.spec):,} params "
          f"({cfg.family} family) on {device}")

    engine = ServeEngine(model, params,
                         max_len=args.prompt_len + args.steps + 1)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype("int32")
    for label in ("first", "warm"):
        t0 = time.perf_counter()
        out = engine.generate(prompts, steps=args.steps, eos_id=args.eos_id)
        dt = time.perf_counter() - t0
        print(f"{label}: generated {out.shape} tokens in {dt:.3f}s "
              f"({out.size / dt:.1f} tok/s)")
    print("first request:", out[0][:12], "...")
    return out


if __name__ == "__main__":
    main()
