"""Training launcher — a thin argv shim over ``repro_torch.api.ElasticSession``.

The port of ``repro.launch.train``, with the same flags, defaults and
per-round lines, and ``--device`` (default ``cuda``; ``--device cpu`` runs
the plain PyTorch versions of the kernels) in place of ``--use-pallas``.
Two modes:

- elastic (the default): k workers, τ-periodic dynamic-weight elastic
  sync, failure injection; one ``round N: ...`` line per round.
- ``--plain``: single-worker training (the k=1 limit), the control; one
  ``step N: loss=...`` line per step.

``--arch`` is the paper's CNN (``paper-cnn``, the default) or a dense LM
(``qwen3-4b``, ``stablelm-3b``, ``h2o-danube-1.8b``; ``--smoke`` for the
reduced config), which trains on the synthetic token stream in windows of
``--seq-len`` tokens; the round lines are the same.

``--save DIR`` writes the master in the reference's checkpoint format at
the end of the run; ``--trace`` / ``--dump-trace`` replay and record the
scenario stream, membership included (controller-applied resizes too);
``--failure-scenario byzantine`` / ``hetero`` drive the adversarial
channels, with ``--score-clip`` and ``--u-zclip`` as the master's clamps.
``--capacity C`` pads the worker axis to C slots so the pool can resize
(``--membership-scenario`` / ``--membership-plan "2:2,4:6"``);
``--controller rules`` attaches the detector → policy → actuator loop of
``repro_torch.control``, which evicts and readmits slots between chunks
from observable telemetry only, and ``--detector-blind`` zeroes the
ground-truth masks echoed into the printed records. ``--groups G
--global-period P`` (with ``--comm-mode fused``) runs hierarchical
averaging: G racks, each with a sub-master its workers exchange with every
round, and a global sync of the sub-masters with the master every P
rounds; the round line adds the racks' ``g_h2`` on sync rounds. ``--placement sharded`` (with
``--comm-mode fused``) splits the slot axis over the ranks of a
``torch.distributed`` group, the capacity padded to a multiple of the
world size; ``--coordinator-address HOST:PORT --num-processes N
--process-id I`` starts rank I of an N-process run (one process per rank,
rank 0's address for all; it needs ``--placement sharded``). With
``--device cuda`` rank I runs on ``cuda:I % device_count``, over NCCL when
every rank has a card of its own and over gloo when ranks share one. Only
rank 0 prints the round lines; every rank prints ``final master l2=``.

    python -m repro_torch.launch.train --workers 8 --tau 4 --rounds 8
    python -m repro_torch.launch.train --device cpu --plain --rounds 5
    python -m repro_torch.launch.train --device cpu --arch stablelm-3b \
        --smoke --rounds 2 --seq-len 16 --batch-size 2
    python -m repro_torch.launch.train --workers 4 --capacity 8 \
        --membership-scenario scale_up --membership-round 3 --rounds 8
    python -m repro_torch.launch.train --workers 8 --controller rules \
        --failure-scenario crash_restart --rounds 12
    python -m repro_torch.launch.train --workers 16 --tau 4 --rounds 8 \
        --comm-mode fused --groups 4 --global-period 2
    python -m repro_torch.launch.train --workers 8 --tau 4 --rounds 8 \
        --comm-mode fused --placement sharded \
        --coordinator-address 127.0.0.1:29500 --num-processes 2 \
        --process-id 0   # and --process-id 1 beside it
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.configs.base import (FAILURE_SCENARIOS, MEMBERSHIP_SCENARIOS,
                                      ElasticConfig, OptimizerConfig)
from repro_torch.core.scenarios import (parse_membership_plan, read_trace,
                                        write_trace)
from repro_torch.launch.mesh import init_distributed, world_and_rank


def main(argv=None):
    """Run the CLI; returns ``(session, records)`` for callers that drive
    it in-process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-cnn")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config of the arch family")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--rounds-per-call", type=int, default=1,
                    help="rounds whose metrics are read back to the host "
                         "together (1 = every round)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=0,
                    help="worker-slot capacity (>= --workers; 0 = exactly "
                         "--workers); membership can resize up to it")
    ap.add_argument("--membership-scenario", default="static",
                    choices=MEMBERSHIP_SCENARIOS,
                    help="planned worker-pool resize stream "
                         "(repro_torch/core/scenarios.py); 'plan' runs "
                         "--membership-plan")
    ap.add_argument("--membership-k", type=int, default=0,
                    help="resize target (scale_up/scale_down) or preempted "
                         "count (preempt_rejoin); 0 = scenario default")
    ap.add_argument("--membership-round", type=int, default=0,
                    help="round the membership event fires (0 = mid-run)")
    ap.add_argument("--membership-plan", default="",
                    help="explicit resize steps 'round:k,round:k' (e.g. "
                         "'2:2,4:6'); implies --membership-scenario plan")
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--optimizer", default="adahessian")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--overlap", type=float, default=0.25)
    ap.add_argument("--failure-prob", type=float, default=1 / 3)
    ap.add_argument("--failure-scenario", default="iid",
                    choices=FAILURE_SCENARIOS,
                    help="failure regime injected into the run "
                         "(see repro_torch/core/scenarios.py)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="replay a recorded scenario trace (JSON-lines) "
                         "instead of drawing a schedule; --rounds/--workers/"
                         "--capacity are coerced to the recorded shape")
    ap.add_argument("--dump-trace", default=None, metavar="PATH",
                    help="after the run, write the executed schedule "
                         "(including controller-applied membership) as a "
                         "replayable JSON-lines trace")
    ap.add_argument("--score-clip", type=float, default=0.0,
                    help="robustness clamp: raw scores above this give the "
                         "worker zero master weight and re-anchor it if it "
                         "diverged past float32 range; 0 = paper behaviour")
    ap.add_argument("--u-zclip", type=float, default=0.0,
                    help="absolute-distance containment: refuse (w2=0) any "
                         "worker whose log-distance sits more than this "
                         "many robust z-scores above the pool (batched "
                         "scoring, --comm-mode fused); 0 = off")
    ap.add_argument("--byzantine-frac", type=float, default=0.25,
                    help="fraction of slots drawn corrupt under "
                         "--failure-scenario byzantine")
    ap.add_argument("--byzantine-mode", default="sign_flip",
                    choices=("sign_flip", "scale", "noise"),
                    help="gradient corruption applied to corrupt slots")
    ap.add_argument("--byzantine-scale", type=float, default=5.0,
                    help="magnitude for the scale/noise corruption modes")
    ap.add_argument("--hetero-dist", default="lognormal",
                    choices=("lognormal", "bimodal"),
                    help="per-slot persistent speed distribution under "
                         "--failure-scenario hetero")
    ap.add_argument("--hetero-sigma", type=float, default=0.6)
    ap.add_argument("--hetero-slow-frac", type=float, default=0.25)
    ap.add_argument("--hetero-slow-scale", type=float, default=0.25)
    ap.add_argument("--no-dynamic", action="store_true")
    ap.add_argument("--comm-mode", default="sequential",
                    choices=("sequential", "fused"),
                    help="communication backend: event-ordered scan "
                         "(paper) or fused batched sync")
    ap.add_argument("--staleness", type=int, default=0, choices=(0, 1),
                    help="delayed averaging depth (DaSGD; requires "
                         "--comm-mode fused)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs every kernel of the path as a CUDA "
                         "kernel; cpu runs their plain PyTorch versions")
    ap.add_argument("--placement", default="single",
                    choices=("single", "sharded"),
                    help="worker placement: sharded splits the slot "
                         "axis over the ranks of a torch.distributed group "
                         "(needs --comm-mode fused)")
    ap.add_argument("--groups", type=int, default=1,
                    help="hierarchical averaging: split the slot axis into "
                         "this many contiguous racks, each with a "
                         "sub-master its workers exchange with every round "
                         "(needs --comm-mode fused; 1 = flat)")
    ap.add_argument("--global-period", type=int, default=1,
                    help="hierarchical averaging: rounds between global "
                         "syncs of the sub-masters with the master "
                         "(needs --comm-mode fused)")
    ap.add_argument("--coordinator-address", default=None,
                    metavar="HOST:PORT",
                    help="multi-process run: rank 0's store address "
                         "(needs --placement sharded)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--controller", default="none",
                    choices=("none", "rules"),
                    help="closed-loop membership control "
                         "(repro_torch.control): 'rules' runs the failure "
                         "detector + rule policy and applies evict/readmit "
                         "at chunk boundaries")
    ap.add_argument("--detector-blind", action="store_true",
                    help="echo a mask-zeroed schedule view into records "
                         "(the controller never sees ground truth anyway; "
                         "this blinds the printed records too)")
    ap.add_argument("--elastic", action="store_true", default=True)
    ap.add_argument("--plain", dest="elastic", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0,
                    help="synthetic dataset generation seed; fixed by "
                         "default so --seed sweeps vary only init/batching/"
                         "schedule on identical data (the §VI convention)")
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)

    membership = args.membership_scenario
    plan = ()
    if args.membership_plan:
        membership = "plan"
        plan = parse_membership_plan(args.membership_plan)
    capacity = args.capacity
    schedule = None
    if args.trace:
        schedule = read_trace(args.trace)
        rounds, cap = schedule.fail.shape
        if (args.rounds, capacity or args.workers) != (rounds, cap):
            print(f"[train] trace {args.trace}: coercing rounds/capacity "
                  f"to the recorded ({rounds}, {cap})")
        args.rounds, capacity = rounds, cap
        args.workers = (int(schedule.active[0].sum())
                        if schedule.active is not None else cap)
        membership, plan = "static", ()  # the trace carries membership
    if membership != "static" and not capacity:
        # resize needs headroom: default the slot pool to the largest
        # worker count the scheduled stream ever reaches; a scale_up with
        # no explicit target grows into its headroom, so give it some
        capacity = max([args.workers, args.membership_k]
                       + [k for _, k in plan])
        if membership == "scale_up" and not args.membership_k:
            capacity = 2 * args.workers
    device = args.device
    if (args.num_processes > 1 or args.coordinator_address
            or args.process_id):
        if args.placement != "sharded":
            raise SystemExit(
                "--coordinator-address/--num-processes/--process-id need "
                "--placement sharded (the worker axis must be split over "
                "the ranks for a multi-process run to mean anything)")
        device = str(init_distributed(args.coordinator_address,
                                      args.num_processes, args.process_id,
                                      args.device))
    world, rank = world_and_rank()
    ecfg = ElasticConfig(
        num_workers=args.workers, capacity=capacity, tau=args.tau,
        alpha=args.alpha,
        overlap_ratio=args.overlap, failure_prob=args.failure_prob,
        dynamic=not args.no_dynamic, comm_mode=args.comm_mode,
        staleness=args.staleness, placement=args.placement,
        failure_scenario=args.failure_scenario,
        score_clip=args.score_clip, u_zclip=args.u_zclip,
        byzantine_frac=args.byzantine_frac,
        byzantine_mode=args.byzantine_mode,
        byzantine_scale=args.byzantine_scale,
        hetero_dist=args.hetero_dist, hetero_sigma=args.hetero_sigma,
        hetero_slow_frac=args.hetero_slow_frac,
        hetero_slow_scale=args.hetero_slow_scale,
        membership_scenario=membership, membership_k=args.membership_k,
        membership_round=args.membership_round, membership_plan=plan,
        groups=args.groups, global_period=args.global_period)
    spec = RunSpec(
        schedule=schedule, arch=args.arch, smoke=args.smoke,
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr),
        elastic=ecfg, rounds=args.rounds,
        rounds_per_call=args.rounds_per_call, seed=args.seed,
        plain=not args.elastic, batch_size=args.batch_size,
        seq_len=args.seq_len, n_data=8000,
        n_test=1000, data_seed=args.data_seed, save_path=args.save,
        device=device,
        controller=(None if args.controller == "none" else args.controller),
        detector_blind=args.detector_blind)
    sess = ElasticSession(spec)
    if sess.ecfg.placement == "sharded" and sess.capacity != ecfg.cap:
        print(f"[train] padding capacity {ecfg.cap} -> {sess.capacity} "
              f"(multiple of the {world} ranks; extra slots stay inactive)")

    # multi-process runs: only rank 0 narrates (every rank runs the rounds;
    # every rank prints the final master-l2 line, so a launcher can check
    # that the ranks agree)
    is_main = rank == 0
    t0 = time.time()
    if is_main and not spec.plain and sess.schedule.has_hetero:
        print(f"[train] persistent slot speeds: "
              f"{np.asarray(sess.schedule.speed[0]).round(3).tolist()}",
              flush=True)
    records = []
    for rec in sess.run_iter():
        records.append(rec)
        if not is_main:
            continue
        if spec.plain:
            print(f"step {rec.round}: loss={rec.loss:.4f}", flush=True)
            continue
        extra = ""
        if sess.schedule.has_membership or sess.controller is not None:
            extra += f" k={rec.num_active}/{sess.capacity}"
        if sess.schedule.has_stragglers:
            extra += f" straggle={rec.straggle.astype(int).tolist()}"
        if sess.schedule.has_restarts:
            extra += f" restart={rec.restart.astype(int).tolist()}"
        if sess.schedule.has_corruption:
            extra += f" corrupt={rec.corrupt.astype(int).tolist()}"
        if rec.g_h2 is not None and np.any(rec.g_h2):
            extra += f" g_h2={np.asarray(rec.g_h2).round(3).tolist()}"
        print(f"round {rec.round}: loss={rec.loss:.4f} "
              f"fails={rec.fail.astype(int).tolist()} "
              f"score={np.asarray(rec.score).round(3).tolist()} "
              f"h2={np.asarray(rec.h2).round(3).tolist()}{extra} "
              f"({time.time()-t0:.1f}s)", flush=True)
    l2 = float(torch.linalg.vector_norm(sess.master_params.double()))
    print(f"[train] final master l2={l2:.10e}", flush=True)
    if sess.controller is not None and is_main:
        applied = [a for a in sess.controller.actuator.log if a.applied]
        print(f"[control] {len(applied)} membership action(s) applied:")
        for a in applied:
            print(f"[control]   round {a.round}: {a.action.describe()} "
                  f"-> {a.live_after} live")
    if args.dump_trace and sess.schedule is not None and is_main:
        write_trace(args.dump_trace, sess.schedule)
        print(f"[train] wrote scenario trace to {args.dump_trace}")
    if args.save:
        print(f"saved master params to {args.save}")
    return sess, records


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
