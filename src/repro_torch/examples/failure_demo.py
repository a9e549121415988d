"""Failure anatomy demo: inject a failure regime and print the full paper
mechanism — u (log distance), raw score a, and the h1/h2 weights — before,
during, and after each fault.

The default ``outage`` scenario is the hand-crafted original: worker 0 loses
master contact for rounds 4–8, injected as a custom ``ScenarioSchedule``
through ``RunSpec.schedule``. ``--scenario`` swaps in any regime from the
scenario engine (``repro_torch.core.scenarios``) by name. The port of
``examples/failure_demo.py``; it runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.failure_demo
    PYTHONPATH=src python -m repro_torch.examples.failure_demo --scenario burst
    PYTHONPATH=src python -m repro_torch.examples.failure_demo \
        --scenario crash_restart --device cpu

``--controller rules`` closes the loop: the failure detector
watches the same u/loss telemetry this demo prints — never the ground-truth
masks — and the rule policy evicts suspect slots and probes them back in.
The per-round table gains a live-pool column and the demo ends with the
controller's action journal, so you can line up each eviction against the
drift that triggered it:

    PYTHONPATH=src python -m repro_torch.examples.failure_demo \
        --scenario crash_restart --controller rules --workers 4
"""
import argparse

import numpy as np

from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.configs.base import (FAILURE_SCENARIOS, ElasticConfig,
                                      OptimizerConfig)
from repro_torch.core.scenarios import ScenarioSchedule


def outage_schedule(rounds, k):
    """The original deterministic demo: worker 0 down for rounds 4–8."""
    fail = np.zeros((rounds, k), bool)
    fail[4:9, 0] = True
    z = np.zeros((rounds, k), bool)
    return ScenarioSchedule(fail, z, z)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="outage",
                    choices=("outage",) + FAILURE_SCENARIOS)
    ap.add_argument("--rounds", type=int, default=14)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--controller", default="none",
                    choices=("none", "rules"),
                    help="'rules' closes the loop: detector verdicts drive "
                         "evict/readmit through ElasticSession.apply")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    controller = None if args.controller == "none" else args.controller

    ecfg = ElasticConfig(num_workers=args.workers, tau=1, alpha=0.1,
                         overlap_ratio=0.25, dynamic=True,
                         failure_scenario=(args.scenario
                                           if args.scenario != "outage"
                                           else "iid"))
    spec = RunSpec(
        arch="paper-cnn",
        optimizer=OptimizerConfig(name="adahessian", lr=0.01),
        elastic=ecfg, rounds=args.rounds, seed=args.seed,
        schedule=(outage_schedule(args.rounds, args.workers)
                  if args.scenario == "outage" else None),
        batch_size=32, n_data=2000, n_test=300, eval_every=1,
        controller=controller, device=args.device)
    sess = ElasticSession(spec)

    pool = " | live" if controller else ""
    print(f"scenario={args.scenario}  (F=comm fail, S=straggle, R=restart, "
          f"C=corrupt; worker-0 column shown)")
    if sess.schedule is not None and sess.schedule.has_hetero:
        print("persistent slot speeds: "
              f"{np.asarray(sess.schedule.speed[0]).round(3).tolist()}")
    print(f" rnd | F S R C |      u0      a0     h1_0   h2_0 |  master_acc"
          f"{pool}")
    for rec in sess.run_iter():
        pool = (f" | {rec.num_active}/{sess.capacity}" if controller else "")
        print(f"  {rec.round:2d} | {int(rec.fail[0])} "
              f"{int(rec.straggle[0])} {int(rec.restart[0])} "
              f"{int(rec.corrupt[0])} "
              f"| {float(rec.u[0]):8.3f} {float(rec.score[0]):8.4f} "
              f"{float(rec.h1[0]):6.3f} {float(rec.h2[0]):6.3f} |"
              f"    {rec.eval_acc:.3f}{pool}")
    if sess.controller is not None:
        applied = [a for a in sess.controller.actuator.log if a.applied]
        print(f"\ncontroller journal ({len(applied)} applied):")
        for a in applied:
            print(f"  round {a.round}: {a.action.describe()} "
                  f"-> {a.live_after} live")

    print("\nWhile a worker is cut off (or straggling) its u drifts; when it "
          "reconnects — or rejoins reset to the master after a crash — the "
          "distance collapses, the score goes negative, and h1→1 / h2→0 "
          "snap the worker back while protecting the master (paper §V-B).")


if __name__ == "__main__":
    main()
