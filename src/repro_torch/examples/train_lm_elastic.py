"""End-to-end driver: train a transformer LM under elastic averaging with
dynamic weighting — the paper's system applied to a real architecture,
driven through ``repro_torch.api.ElasticSession`` (the port of the
reference's ``examples/train_lm_elastic.py``, same presets and flags).

The default preset trains a small qwen3-family model (d_model 128, 4
layers) for 12 rounds on the synthetic token stream; ``--preset 10m`` and
``--preset 100m`` scale it (the 100m preset, head_dim 64 at 512 tokens,
is the flash kernel's shape: its held-out evals, ``--eval-every``, run
through it on the card, while training takes the differentiable
attention). Runs on the card by default; ``--device cpu`` runs the plain
PyTorch versions of the kernels:

    PYTHONPATH=src python -m repro_torch.examples.train_lm_elastic \\
        --device cpu --preset ci --rounds 2
    PYTHONPATH=src python -m repro_torch.examples.train_lm_elastic \\
        --preset 100m --rounds 3 --eval-every 1 --worker-chunk 1

``--worker-chunk 1`` maps one worker at a time through the local phase's
``vmap(jvp(grad))``: at the 100m preset's 16 x 512 tokens a worker's
transform keeps most of an 80 GB card alive, so four at once do not fit.
"""
import argparse
import time

import numpy as np

from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.configs.base import (ElasticConfig, OptimizerConfig,
                                      get_config)
from repro_torch.nn.param import param_count

PRESETS = {
    # name: (d_model, layers, heads, d_ff, seq, batch, rounds)
    "ci": (128, 4, 4, 256, 128, 8, 12),
    "10m": (256, 8, 8, 1024, 256, 8, 60),
    "100m": (768, 12, 12, 3072, 512, 16, 300),
}


def preset_config(preset: str):
    """The preset's qwen3-family config, float32 params and activations."""
    d, L, H, ff, _, _, _ = PRESETS[preset]
    return get_config("qwen3-4b").replace(
        name=f"qwen3-{preset}", num_layers=L, d_model=d, num_heads=H,
        num_kv_heads=max(1, H // 4), head_dim=d // H, d_ff=ff,
        vocab_size=4096, dtype="float32", param_dtype="float32")


def main(argv=None):
    """Run the example; returns ``(session, records)`` for callers that
    drive it in-process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="ci", choices=sorted(PRESETS))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=0,
                    help="rounds to run (0 = the preset's)")
    ap.add_argument("--rounds-per-call", type=int, default=1)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out eval of the master every N rounds and "
                         "at the last (0 = never)")
    ap.add_argument("--worker-chunk", type=int, default=0,
                    help="workers per vmapped local-phase call (0 = all): "
                         "bounds the activations kept for jvp(grad), which "
                         "the 100m preset at k=4 needs on an 80 GB card")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)

    _, _, _, _, seq, bsz, rounds = PRESETS[args.preset]
    rounds = args.rounds or rounds
    cfg = preset_config(args.preset)
    spec = RunSpec(
        model_cfg=cfg,
        optimizer=OptimizerConfig(name="adahessian", lr=0.002),
        elastic=ElasticConfig(num_workers=args.workers, tau=args.tau,
                              alpha=0.1, overlap_ratio=0.25,
                              failure_prob=1 / 3, dynamic=True),
        rounds=rounds, rounds_per_call=args.rounds_per_call,
        seed=0, scenario_seed=3, batch_size=bsz, seq_len=seq,
        n_tokens=400_000, eval_every=args.eval_every,
        worker_chunk=args.worker_chunk or None, device=args.device)
    sess = ElasticSession(spec)
    print(f"model: {cfg.name}  params={param_count(sess.model.spec):,}  "
          f"device={sess.device}")

    t0 = time.time()
    records = []
    for rec in sess.run_iter():
        records.append(rec)
        if rec.round % 5 == 0 or rec.round == rounds - 1:
            ev = ("" if rec.eval_loss is None
                  else f" | master eval loss {rec.eval_loss:6.3f}")
            print(f"round {rec.round:3d} | worker loss {rec.loss:6.3f} | "
                  f"h2 {np.asarray(rec.h2).round(3)}{ev} | "
                  f"{time.time()-t0:6.1f}s", flush=True)
    if args.save:
        sess.save(args.save, extra_metadata={"preset": args.preset})
        print("saved:", args.save)
    return sess, records


if __name__ == "__main__":
    main()
