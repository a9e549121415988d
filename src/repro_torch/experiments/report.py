"""The §Repro tables and the paper-claim checklist from the port's grid
artifacts (``results/paper_repro/*.json``, written by
``repro_torch.experiments.grid``).

``repro_tables`` and ``claims_section`` read the same JSON files as
``repro.experiments.report`` and render the same text. The reference's
dry-run and roofline sections read XLA HLO; their torch counterparts
belong to the tooling slice, and ``dryrun_table`` / ``roofline_section``
raise naming it.

    python -m repro_torch.experiments.report [--results DIR]
"""
from __future__ import annotations

import glob
import json
from collections import defaultdict

RESULTS = "results"
METHODS = ["EASGD", "EAMSGD", "EAHES", "EAHES-O", "EAHES-OM", "DEAHES-O"]


def _load(path):
    with open(path) as f:
        return json.load(f)


def repro_tables(results: str = RESULTS) -> str:
    files = glob.glob(f"{results}/paper_repro/fig45_*.json")
    out = []
    if not files:
        return "_grid not yet run_\n"
    by_panel = defaultdict(lambda: defaultdict(list))
    for path in files:
        r = _load(path)
        by_panel[(r["k"], r["tau"])][r["method"]].append(r["final_acc"])
    n_seeds = max((len(v) for p in by_panel.values() for v in p.values()),
                  default=1)
    out.append("### Final test accuracy (synthetic-MNIST proxy; "
               "communication rounds = 16/12/8 for τ=1/2/4; comm suppressed "
               f"1/3 of rounds; mean over up to {n_seeds} seed(s))\n")
    out.append("| k | τ | " + " | ".join(METHODS) + " |")
    out.append("|---|---|" + "---|" * len(METHODS))
    for (k, tau) in sorted(by_panel):
        row = [str(k), str(tau)]
        for m in METHODS:
            accs = by_panel[(k, tau)].get(m)
            if not accs:
                row.append("—")
            elif len(accs) == 1:
                row.append(f"{accs[0]:.3f}")
            else:
                mean = sum(accs) / len(accs)
                spread = (max(accs) - min(accs)) / 2
                row.append(f"{mean:.3f}±{spread:.2f}")
        out.append("| " + " | ".join(row) + " |")
    f3 = sorted(glob.glob(f"{results}/paper_repro/fig3_*.json"))
    if f3:
        out.append("\n### Fig. 3 — overlap ratio sweep (EAHES-O, k=4, τ=1)\n")
        out.append("| overlap r | final acc |")
        out.append("|---|---|")
        for path in f3:
            r = _load(path)
            out.append(f"| {r['overlap_ratio']:.3f} | {r['final_acc']:.3f} |")
    return "\n".join(out) + "\n"


def _tooling(section: str):
    raise NotImplementedError(
        f"the {section} section reads XLA HLO; its torch counterpart belongs "
        "to the tooling slice (FLOP counting plus the profiler), which is "
        "not ported to PyTorch yet")


def dryrun_table(results: str = RESULTS) -> str:
    _tooling("dry-run")


def roofline_section(results: str = RESULTS) -> str:
    _tooling("roofline")


def claims_section(results: str = RESULTS) -> str:
    """Claim-by-claim verdicts from the grid artifacts."""
    files = glob.glob(f"{results}/paper_repro/fig45_*.json")
    if not files:
        return "_grid not yet run_\n"
    runs = defaultdict(list)
    for path in files:
        r = _load(path)
        runs[(r["method"], r["k"], r["tau"])].append(r["final_acc"])

    def acc(m, k, tau):
        vals = runs.get((m, k, tau))
        return sum(vals) / len(vals) if vals else None

    # compare only on panels where every method has a result (partial grids
    # would otherwise bias the averages)
    all_methods = sorted({m for (m, _, _) in runs})
    common = [(k, t) for k in (4, 8) for t in (1, 2, 4)
              if all(acc(m, k, t) is not None for m in all_methods)]

    def avg(m):
        vals = [acc(m, k, t) for (k, t) in common]
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else None

    lines = ["| paper claim (§VII) | our measurement | verdict |",
             "|---|---|---|"]

    def fmt(v):
        return f"{v:.3f}" if v is not None else "—"

    hess = [avg(m) for m in ("EAHES", "EAHES-O", "EAHES-OM", "DEAHES-O")]
    hess = [h for h in hess if h is not None]
    sgd = [avg(m) for m in ("EASGD", "EAMSGD")]
    sgd = [s for s in sgd if s is not None]
    if hess and sgd:
        ok = min(hess) > max(sgd)
        lines.append(
            f"| AdaHessian-based methods significantly outperform SGD-based"
            f" | min(hess-avg)={fmt(min(hess))} vs max(sgd-avg)="
            f"{fmt(max(sgd))} | {'CONFIRMED' if ok else 'NOT confirmed'} |")
    a_om, a_d = avg("EAHES-OM"), avg("DEAHES-O")
    others = [avg(m) for m in ("EASGD", "EAMSGD", "EAHES", "EAHES-O")]
    others = [o for o in others if o is not None]
    if a_om is not None and a_d is not None:
        close = abs(a_om - a_d) < 0.05
        lines.append(
            f"| DEAHES-O ≈ EAHES-OM (oracle) | Δavg="
            f"{abs(a_om - a_d):.3f} | "
            f"{'CONFIRMED' if close else 'NOT confirmed'} |")
        if others:
            beats = a_d > max(others) - 0.01
            lines.append(
                f"| DEAHES-O outperforms all non-oracle baselines | "
                f"DEAHES-O={fmt(a_d)} vs best-other={fmt(max(others))} | "
                f"{'CONFIRMED' if beats else 'NOT confirmed'} |")
    a_eo, a_e = avg("EAHES-O"), avg("EAHES")
    if a_eo is not None and a_e is not None:
        lines.append(
            f"| data overlap helps Hessian-based methods (EAHES-O > EAHES) "
            f"| {fmt(a_eo)} vs {fmt(a_e)} | "
            f"{'CONFIRMED' if a_eo > a_e - 0.005 else 'NOT confirmed'} |")
    # scaling k 4→8, τ 1→4 does not degrade (check DEAHES-O)
    base = acc("DEAHES-O", 4, 1)
    worst = min((acc("DEAHES-O", k, t) or 1.0)
                for k in (4, 8) for t in (1, 2, 4))
    if base:
        lines.append(
            f"| performance does not degrade with k 4→8, τ 1→4 | "
            f"DEAHES-O worst-panel={fmt(worst)} vs (4,1)={fmt(base)} "
            f"(per-τ round budgets differ; compare within panel) | "
            f"{'CONFIRMED' if worst > base - 0.10 else 'MIXED'} |")
    f3 = sorted(glob.glob(f"{results}/paper_repro/fig3_*.json"))
    if f3:
        rs = sorted((_load(p) for p in f3), key=lambda r: r["overlap_ratio"])
        corr_up = rs[-1]["final_acc"] >= rs[0]["final_acc"] - 0.01
        accs = ", ".join(f"r={r['overlap_ratio']:g}:{r['final_acc']:.3f}"
                         for r in rs)
        lines.append(
            f"| positive relationship between overlap ratio and accuracy "
            f"(fig 3) | {accs} | "
            f"{'CONFIRMED' if corr_up else 'NOT confirmed'} |")
    lines.append(
        f"\n*(averages over the {len(common)} panel(s) common to all "
        "methods: " + ", ".join(f"k={k},τ={t}" for k, t in common) + ")*\n\n"
        "**Variance caveat.** The grid runs 16/12/8 rounds (shorter than "
        "the paper's horizons) with few seeds; per-panel seed spreads "
        "(± in the table above) can exceed the gaps the paper reports "
        "*between* the AdaHessian variants, so their fine ordering is "
        "reported as measured, not smoothed.")
    return "\n".join(lines) + "\n"


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    print("## §Repro — paper §VII reproduction\n")
    print(repro_tables(args.results))
    print("## §Claims — paper-claim checklist\n")
    print(claims_section(args.results))


if __name__ == "__main__":
    main()
