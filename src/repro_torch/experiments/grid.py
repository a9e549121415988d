"""Paper figs 4–5 grid runner on the port: 6 methods × k∈{4,8} × τ∈{1,2,4}
(+ seeds), run as a bounded pool of subprocesses, each one
``python -m repro_torch.experiments.paper_repro`` on ``--device``.

The jobs are the reference's (``repro.experiments.grid``): the same
command lines, with the port's module path and ``--device`` added. Also
fig 3, the overlap-ratio sweep {0, .125, .25, .375, .5} on EAHES-O, and the
scenario axis: every failure regime of ``repro_torch.core.scenarios`` ×
{EASGD, EAHES-O, DEAHES-O} at k=4/τ=1.

Results land in ``results/paper_repro/*.json`` (``results=`` moves them);
``repro_torch.experiments.report`` renders the tables.

    python -m repro_torch.experiments.grid --what fig45 --device cuda
"""
from __future__ import annotations

import glob
import itertools
import json
import os
import subprocess
import sys
import time

RESULTS = "results/paper_repro"
# the directory holding the repro_torch package, for the jobs' PYTHONPATH
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def job_cmd(method, k, tau, seed, rounds, out, overlap=None, scenario=None,
            rounds_per_call=1, device="cuda"):
    cmd = [sys.executable, "-m", "repro_torch.experiments.paper_repro",
           "--method", method, "--k", str(k), "--tau", str(tau),
           "--seed", str(seed), "--rounds", str(rounds), "--out", out,
           "--rounds-per-call", str(rounds_per_call)]
    if overlap is not None:
        cmd += ["--overlap-ratio", str(overlap)]
    if scenario is not None:
        cmd += ["--failure-scenario", scenario]
    return cmd + ["--device", device]


def run_pool(jobs, max_procs=5):
    """Run jobs as a bounded subprocess pool; returns the list of failed job
    names (empty when everything exited 0). A job's standard error goes to
    this process's, so a failing job says why."""
    procs = []
    t0 = time.time()
    pending = list(jobs)
    done = 0
    total = len(pending)
    failed = []
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    while pending or procs:
        while pending and len(procs) < max_procs:
            name, cmd = pending.pop(0)
            procs.append((name, subprocess.Popen(
                cmd, env=env, stdout=subprocess.DEVNULL)))
        still = []
        for name, p in procs:
            if p.poll() is None:
                still.append((name, p))
            else:
                done += 1
                status = "ok" if p.returncode == 0 else f"FAIL({p.returncode})"
                if p.returncode != 0:
                    failed.append(name)
                print(f"[{time.time()-t0:7.1f}s] {done}/{total} {name}: "
                      f"{status}", flush=True)
        procs = still
        if procs:
            time.sleep(0.5)
    return failed


# Communication-round budget per τ (τ=4 costs 4× the local compute per
# round, so the high-τ panels get fewer rounds), as in the reference.
ROUNDS_BY_TAU = {1: 16, 2: 12, 4: 8}


def grid_jobs(rounds=None, seeds=(0,), methods=None, ks=(4, 8),
              taus=(1, 2, 4), rounds_per_call=1, device="cuda",
              results=RESULTS):
    from repro_torch.experiments.paper_repro import METHODS

    methods = methods or sorted(METHODS)
    jobs = []
    # τ-major order: complete (τ=1) panels land first so partial runs still
    # yield full method comparisons
    for tau, k, m, s in itertools.product(taus, ks, methods, seeds):
        r = rounds or ROUNDS_BY_TAU[tau]
        out = f"{results}/fig45_{m}_k{k}_tau{tau}_s{s}.json"
        if os.path.exists(out):
            continue
        jobs.append((f"{m} k={k} τ={tau} s={s}",
                     job_cmd(m, k, tau, s, r, out,
                             rounds_per_call=rounds_per_call,
                             device=device)))
    return jobs


def scenario_jobs(rounds=12, seeds=(0,), scenarios=None,
                  methods=("EASGD", "EAHES-O", "DEAHES-O"), k=4, tau=1,
                  rounds_per_call=1, device="cuda", results=RESULTS):
    """Failure-regime axis: every scenario from the engine × the headline
    methods, at the paper's k=4/τ=1 operating point."""
    from repro_torch.configs.base import FAILURE_SCENARIOS

    scenarios = scenarios or FAILURE_SCENARIOS
    jobs = []
    for sc, m, s in itertools.product(scenarios, methods, seeds):
        out = f"{results}/scen_{sc}_{m}_k{k}_tau{tau}_s{s}.json"
        if os.path.exists(out):
            continue
        jobs.append((f"{m} scen={sc} s={s}",
                     job_cmd(m, k, tau, s, rounds, out, scenario=sc,
                             rounds_per_call=rounds_per_call,
                             device=device)))
    return jobs


def overlap_jobs(rounds=16, seeds=(0,), ratios=(0.0, 0.125, 0.25, 0.375, 0.5),
                 rounds_per_call=1, device="cuda", results=RESULTS):
    jobs = []
    for r, s in itertools.product(ratios, seeds):
        out = f"{results}/fig3_r{r}_s{s}.json"
        if os.path.exists(out):
            continue
        jobs.append((f"overlap r={r} s={s}",
                     job_cmd("EAHES-O", 4, 1, s, rounds, out, overlap=r,
                             rounds_per_call=rounds_per_call,
                             device=device)))
    return jobs


def summarize(pattern=f"{RESULTS}/*.json"):
    rows = []
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=None,
                    help="override the per-τ round budget")
    ap.add_argument("--rounds-per-call", type=int, default=1,
                    help="rounds read back together, passed to every job "
                         "(numbers are unchanged)")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--max-procs", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--what", default="all",
                    choices=["all", "fig45", "fig3", "scenarios"])
    args = ap.parse_args(argv)
    seeds = tuple(range(args.seeds))
    kw = dict(rounds_per_call=args.rounds_per_call, device=args.device,
              results=args.results)
    jobs = []
    if args.what in ("all", "fig45"):
        jobs += grid_jobs(args.rounds, seeds, **kw)
    if args.what in ("all", "fig3"):
        jobs += overlap_jobs(args.rounds or 16, seeds, **kw)
    if args.what in ("all", "scenarios"):
        jobs += scenario_jobs(args.rounds or 12, seeds, **kw)
    print(f"{len(jobs)} jobs")
    failed = run_pool(jobs, args.max_procs)
    if failed:
        print(f"{len(failed)} job(s) failed: " + ", ".join(failed),
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
