"""The port's §VI grid and report against the reference's, and the port's
examples, on the CPU.

Every job of ``repro_torch.experiments.grid`` is the reference grid's
command line with the port's module path and ``--device`` added, and
nothing else; ``run_pool`` runs one such job to its JSON on the CPU.
``repro_tables`` renders the same text from the same JSON files in both
packages, and ``claims_section`` the same verdict table; the sections that
read XLA HLO raise naming the tooling slice. The examples run as modules.
"""
import json

import numpy as np
import pytest

from repro.experiments import grid as rgrid
from repro.experiments import report as rreport
from repro_torch.examples import failure_demo, quickstart
from repro_torch.experiments import grid as tgrid
from repro_torch.experiments import report as treport
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _as_port(cmd, device):
    mod = cmd.index("repro.experiments.paper_repro")
    return (cmd[:mod] + ["repro_torch.experiments.paper_repro"]
            + cmd[mod + 1:] + ["--device", device])


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_grid_jobs_are_the_reference_jobs(tmp_path, monkeypatch, device):
    monkeypatch.chdir(tmp_path)
    for kind, kw in (("grid_jobs", dict(seeds=(0, 1))),
                     ("scenario_jobs", dict(rounds=5)),
                     ("overlap_jobs", dict(rounds_per_call=2))):
        want = getattr(rgrid, kind)(**kw)
        got = getattr(tgrid, kind)(device=device, **kw)
        assert [n for n, _ in got] == [n for n, _ in want], kind
        assert [c for _, c in got] == [_as_port(c, device)
                                       for _, c in want], kind
    assert len(tgrid.grid_jobs()) == 36
    # a finished job's JSON is not run again, in either package
    done = tmp_path / tgrid.RESULTS / "fig3_r0.0_s0.json"
    done.parent.mkdir(parents=True)
    done.write_text("{}")
    assert len(tgrid.overlap_jobs()) == len(rgrid.overlap_jobs()) == 4


def test_run_pool_runs_a_job_to_its_json(tmp_path, capsys):
    out = str(tmp_path / "paper_repro" / "fig45_EASGD_k2_tau1_s0.json")
    cmd = tgrid.job_cmd("EASGD", 2, 1, 0, 2, out, device="cpu")
    assert tgrid.run_pool([("EASGD k=2", cmd),
                           ("bad", cmd[:-1] + ["tpu"])], max_procs=2) \
        == ["bad"]
    assert "1/2" in capsys.readouterr().out
    res = json.loads(open(out).read())
    assert (res["method"], res["k"], res["device"]) == ("EASGD", 2, "cpu")
    assert len(res["round_ms"]) == 2 and 0.0 <= res["final_acc"] <= 1.0


def _write_results(root):
    rng = np.random.default_rng(0)
    pr = root / "results" / "paper_repro"
    pr.mkdir(parents=True)
    for k in (4, 8):
        for tau in (1, 2, 4):
            for m in ("EASGD", "EAMSGD", "EAHES", "EAHES-O", "EAHES-OM",
                      "DEAHES-O"):
                for s in ((0, 1) if tau == 1 else (0,)):
                    if (k, tau, m) == (8, 4, "EAMSGD"):
                        continue  # a partial grid
                    (pr / f"fig45_{m}_k{k}_tau{tau}_s{s}.json").write_text(
                        json.dumps({"method": m, "k": k, "tau": tau,
                                    "final_acc": float(rng.random())}))
    for r in (0.0, 0.125, 0.25):
        (pr / f"fig3_r{r}_s0.json").write_text(json.dumps(
            {"overlap_ratio": r, "final_acc": float(rng.random())}))


def test_report_renders_the_reference_tables(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert treport.repro_tables() == rreport.repro_tables() \
        == "_grid not yet run_\n"
    _write_results(tmp_path)
    want = rreport.repro_tables()
    assert treport.repro_tables() == want
    assert treport.repro_tables(str(tmp_path / "results")) == want
    assert "| 8 | 4 |" in want and "±" in want and "Fig. 3" in want
    # the verdict table is the reference's; the caveat under it is the
    # port's own
    cut = lambda text: text.split("\n*(averages")[0]
    assert cut(treport.claims_section()) == cut(rreport.claims_section())
    for section in (treport.dryrun_table, treport.roofline_section):
        with pytest.raises(NotImplementedError, match="tooling slice"):
            section()


def test_examples_run_as_modules(capsys):
    quickstart.main(["--device", "cpu", "--rounds", "1"])
    out = capsys.readouterr().out
    assert out.count("master acc") == 1
    failure_demo.main(["--device", "cpu", "--rounds", "4", "--workers", "2",
                       "--scenario", "crash_restart", "--controller",
                       "rules"])
    out = capsys.readouterr().out
    assert "controller journal" in out and "| live" in out
    assert out.count(" | ") >= 4
