"""Paper §VI–§VII reproduction on the port: one (method, k, τ, seed) run.

Methods (paper §VI):
    EASGD     — async EASGD            (SGD local steps, fixed α)
    EAMSGD    — EASGD + momentum       (momentum local steps, fixed α)
    EAHES     — elastic AdaHessian     (fixed α, no overlap)
    EAHES-O   — EAHES + data overlap
    EAHES-OM  — EAHES-O + oracle α schedule (knows the failure schedule)
    DEAHES-O  — EAHES-O + dynamic weighting (the paper's method)

The same mapping of method names onto configs as
``repro.experiments.paper_repro``, driving the port's ``ElasticSession`` on
``device`` (default ``"cuda"``: the hand-written kernels). Run on the card:

    python -m repro_torch.experiments.paper_repro --method DEAHES-O --k 8 --tau 4
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.configs.base import (FAILURE_SCENARIOS, ElasticConfig,
                                      OptimizerConfig)

METHODS = {
    # name: (optimizer, dynamic, oracle, use_overlap)
    "EASGD": ("sgd", False, False, False),
    "EAMSGD": ("momentum", False, False, False),
    "EAHES": ("adahessian", False, False, False),
    "EAHES-O": ("adahessian", False, False, True),
    "EAHES-OM": ("adahessian", False, True, True),
    "DEAHES-O": ("adahessian", True, False, True),
}

# paper §VII: best grid α = 0.1; lr 0.01; momentum 0.5; betas (0.9, 0.999)
LR = 0.01
ALPHA = 0.1


def paper_overlap_ratio(k: int) -> float:
    return 0.25 if k <= 4 else 0.125


def run_one(
    method: str,
    k: int,
    tau: int,
    seed: int = 0,
    rounds: int = 30,
    batch_size: int = 32,
    n_data: int = 8000,
    n_test: int = 600,
    failure_prob: float = 1.0 / 3.0,
    overlap_ratio: Optional[float] = None,
    eval_every: int = 2,
    out_path: Optional[str] = None,
    score_k: float = -0.05,
    failure_scenario: str = "iid",
    rounds_per_call: int = 1,
    score_clip: float = 0.0,
    comm_mode: str = "sequential",
    device: str = "cuda",
    params=None,
):
    """The reference's ``run_one`` on the port. ``comm_mode`` picks the
    comm backend; ``params`` (a reference-layout parameter tree) seats the
    initial model instead of the port's own init. The result adds the
    per-round ``round_ms`` to the reference's fields."""
    opt_name, dynamic, oracle, use_overlap = METHODS[method]
    r = (overlap_ratio if overlap_ratio is not None
         else (paper_overlap_ratio(k) if use_overlap else 0.0))
    ecfg = ElasticConfig(
        num_workers=k, tau=tau, alpha=ALPHA, overlap_ratio=r,
        failure_prob=failure_prob, dynamic=dynamic, oracle=oracle,
        score_k=score_k, failure_scenario=failure_scenario,
        score_clip=score_clip, comm_mode=comm_mode)
    ocfg = OptimizerConfig(name=opt_name, lr=LR, momentum=0.5,
                           betas=(0.9, 0.999), hutchinson_samples=1)
    spec = RunSpec(
        arch="paper-cnn", optimizer=ocfg, elastic=ecfg, rounds=rounds,
        rounds_per_call=rounds_per_call, seed=seed, batch_size=batch_size,
        n_data=n_data, n_test=n_test, data_seed=0, eval_every=eval_every,
        device=device)
    sess = ElasticSession(spec, params=params)

    curves = {"round": [], "train_loss": [], "test_loss": [], "test_acc": [],
              "score": [], "h2": []}
    round_ms = []
    t0 = time.time()
    for rec in sess.run_iter():
        round_ms.append(rec.round_ms)
        if rec.eval_loss is None:
            continue
        curves["round"].append(rec.round)
        curves["train_loss"].append(rec.loss)
        curves["test_loss"].append(rec.eval_loss)
        curves["test_acc"].append(rec.eval_acc)
        curves["score"].append(np.asarray(rec.score).tolist())
        curves["h2"].append(np.asarray(rec.h2).tolist())

    result = {
        "method": method, "k": k, "tau": tau, "seed": seed,
        "rounds": rounds, "overlap_ratio": r, "alpha": ALPHA,
        "failure_prob": failure_prob, "failure_scenario": failure_scenario,
        "comm_mode": comm_mode, "device": str(sess.device),
        "curves": curves,
        "final_acc": curves["test_acc"][-1] if curves["test_acc"] else None,
        "round_ms": round_ms,
        "wall_s": round(time.time() - t0, 1),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f)
    return result


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--method", required=True, choices=sorted(METHODS))
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--rounds-per-call", type=int, default=1)
    ap.add_argument("--overlap-ratio", type=float, default=None)
    ap.add_argument("--failure-scenario", default="iid",
                    choices=FAILURE_SCENARIOS)
    ap.add_argument("--comm-mode", default="sequential",
                    choices=("sequential", "fused"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = run_one(args.method, args.k, args.tau, args.seed,
                  rounds=args.rounds, overlap_ratio=args.overlap_ratio,
                  out_path=args.out, failure_scenario=args.failure_scenario,
                  rounds_per_call=args.rounds_per_call,
                  comm_mode=args.comm_mode, device=args.device)
    print(json.dumps({k: v for k, v in res.items() if k != "curves"}))


if __name__ == "__main__":
    main()
