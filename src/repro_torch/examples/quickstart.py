"""Quickstart: the paper's system in ~20 lines via the port's session API.

Trains the paper's CNN with k=4 elastic AdaHessian workers under a 1/3
communication-failure rate, with dynamic weighting (DEAHES-O). Prints the
per-round raw scores and h1/h2 weights so you can watch the mechanism
react. Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import numpy as np

from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.configs.base import ElasticConfig, OptimizerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    spec = RunSpec(
        arch="paper-cnn",
        optimizer=OptimizerConfig(name="adahessian", lr=0.01),
        elastic=ElasticConfig(num_workers=4, tau=1, alpha=0.1,
                              overlap_ratio=0.25, failure_prob=1 / 3,
                              dynamic=True),
        rounds=args.rounds, seed=0, batch_size=32, n_data=4000, n_test=500,
        eval_every=1, device=args.device)

    for rec in ElasticSession(spec).run_iter():
        print(f"round {rec.round:2d} | loss {rec.loss:6.3f} | "
              f"master acc {rec.eval_acc:.3f} | "
              f"fails {rec.fail.astype(int)} | "
              f"score {np.asarray(rec.score).round(3)} | "
              f"h2 {np.asarray(rec.h2).round(3)}")

    print("\nDynamic weighting kept the master safe from suppressed workers;"
          " python -m repro_torch.experiments.grid runs the full paper grid.")


if __name__ == "__main__":
    main()
