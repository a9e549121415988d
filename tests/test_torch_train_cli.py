"""The port's training CLI (``repro_torch.launch.train``) on ``--device
cpu``: its per-round lines in the reference CLI's format, ``--save`` read
back by a session restore, ``--dump-trace`` / ``--trace`` replay (the
membership stream included), the adversarial scenarios' extra fields, the
membership and closed-loop control flags, and the refusal by name of every
flag whose slice is not ported yet."""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro.launch import train as rtrain
from repro_torch.api.session import ElasticSession
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.launch import train as ttrain
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# byzantine at 4 workers, seed 0: slot 3 corrupt (asserted below)
BYZANTINE = ["--rounds", "2", "--workers", "4", "--batch-size", "4",
             "--failure-scenario", "byzantine", "--byzantine-frac", "0.5"]
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def _shape(text):
    """Each output line with every number replaced by ``#``."""
    return [NUMBER.sub("#", line) for line in text.strip().splitlines()]


def test_round_lines_follow_the_reference_format(capsys):
    rtrain.main(BYZANTINE)
    want = capsys.readouterr().out
    sess, records = ttrain.main(BYZANTINE + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _shape(got) == _shape(want)
    assert [r.corrupt.tolist() for r in records] == [[False, False, False,
                                                      True]] * 2
    assert "corrupt=[0, 0, 0, 1]" in got and got.count("round ") == 2
    assert re.search(r"\[train\] final master l2=\d\.\d{10}e\+\d\d", got)
    assert sess.round == 2 and all(torch.isfinite(torch.tensor(
        [r.loss for r in records])))


def test_plain_mode_prints_steps(capsys):
    sess, records = ttrain.main(["--device", "cpu", "--plain", "--rounds",
                                 "3", "--batch-size", "4", "--optimizer",
                                 "adam", "--lr", "1e-4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [re.fullmatch(r"step (\d+): loss=\d+\.\d{4}", line).group(1)
            for line in lines[:3]] == ["0", "1", "2"]
    assert lines[3].startswith("[train] final master l2=")
    assert sess.spec.plain and len(records) == 3


def test_save_then_restore_and_trace_replay(tmp_path, capsys):
    """``--save`` writes the master at the end of the run; a session
    restore reads it back bit for bit. ``--dump-trace`` records the
    schedule, and ``--trace`` replays it to the same run."""
    ck, trace = str(tmp_path / "ck"), str(tmp_path / "run.jsonl")
    args = ["--device", "cpu", "--rounds", "2", "--workers", "4",
            "--batch-size", "4", "--failure-scenario", "hetero", "--tau",
            "2"]
    sess, _ = ttrain.main(args + ["--save", ck, "--dump-trace", trace])
    out = capsys.readouterr().out
    # lognormal speeds of scenario seed 7: slots 2 and 3 slow
    assert "[train] persistent slot speeds: [1.0, 1.0, 0.84" in out
    assert f"saved master params to {ck}" in out
    assert tck.read_metadata(ck)["scenario"] == "hetero"
    warm = ElasticSession(dataclasses.replace(sess.spec, save_path=None))
    warm.restore(ck)
    assert torch.equal(warm.state["master"], sess.state["master"])
    replay, _ = ttrain.main(args[:4] + ["--batch-size", "4", "--tau", "2",
                                        "--trace", trace, "--rounds", "5"])
    assert "coercing rounds/capacity to the recorded (2, 4)" in \
        capsys.readouterr().out
    assert torch.equal(replay.state["master"], sess.state["master"])


# Each case keeps the ID it had while every flag below was refused. Every
# slice has since been ported: each case now checks that the flag runs and
# takes effect. The multi-process flags need ``--placement sharded`` (the
# reference's rule); their two-rank run is tests/test_torch_distributed.py.
FLAG_CASES = [
    (["--capacity", "6"], "membership"),
    (["--membership-scenario", "scale_up"], "membership"),
    (["--membership-k", "2"], "membership"),
    (["--membership-round", "3"], "membership"),
    (["--membership-plan", "2:2"], "membership"),
    (["--controller", "rules"], "closed-loop control"),
    (["--detector-blind"], "closed-loop control"),
    (["--placement", "sharded", "--comm-mode", "fused"], "placement"),
    (["--groups", "2", "--comm-mode", "fused"], "hierarchical"),
    (["--global-period", "2", "--comm-mode", "fused"], "hierarchical"),
    (["--coordinator-address", "localhost:1234"], "multi-process"),
    (["--num-processes", "2"], "multi-process"),
    (["--process-id", "1"], "multi-process")]
PORTED = ("membership", "closed-loop control", "hierarchical", "placement",
          "multi-process")


@pytest.mark.parametrize("flags,slice_name", [
    pytest.param(f, s, id=f"flags{i}-{s}")
    for i, (f, s) in enumerate(FLAG_CASES)])
def test_unported_flags_are_refused_by_name(flags, slice_name, capsys):
    argv = ["--device", "cpu", "--rounds", "2", "--workers", "2",
            "--batch-size", "4"] + flags
    if slice_name not in PORTED:
        with pytest.raises(NotImplementedError,
                           match=f"{flags[0]} belongs to .*{slice_name}"):
            ttrain.main(argv)
        return
    if slice_name == "multi-process":
        with pytest.raises(SystemExit, match="need --placement sharded"):
            ttrain.main(argv)
        if flags[0] == "--process-id":  # rank 1 of a one-process run
            with pytest.raises(ValueError, match="process id 1 outside"):
                ttrain.main(argv + ["--placement", "sharded", "--comm-mode",
                                    "fused"])
        return
    sess, records = ttrain.main(argv)
    out = capsys.readouterr().out
    assert len(records) == 2 and sess.round == 2
    if flags[0] == "--capacity":
        assert sess.capacity == 6 and "k=2/6" in out
    elif flags[1:] == ["scale_up"]:  # capacity 2·workers, grows mid-run
        assert [r.num_active for r in records] == [2, 4]
    elif flags[0] == "--controller":
        assert sess.controller is not None and "[control] " in out
    elif slice_name == "hierarchical":  # two racks of one, or a period of 2
        assert sess.trainer._hier and sess.ecfg.comm_mode == "fused"
        assert [r.g_h2.shape for r in records] == [
            (sess.trainer._n_groups,)] * 2
        if flags[0] == "--global-period":  # round 0 is off the cycle
            assert not records[0].g_h2.any() and "g_h2=" not in \
                out.splitlines()[0]
    elif slice_name == "placement":  # world size 1: no group, no padding
        assert sess.trainer._sharded and sess.trainer._world == 1
        assert sess.capacity == 2 and "padding" not in out
    elif flags[0] == "--detector-blind":
        assert sess.spec.detector_blind
        assert not any(r.fail.any() for r in records)
    else:  # no event inside two rounds: the pool stays as it was
        assert sess.ecfg.membership_k == 2 or sess.capacity == 2
        assert all(r.num_active == 2 for r in records)


def test_membership_and_controller_trace_replay(tmp_path, capsys):
    """``--dump-trace`` records the membership the run executed, a
    controller's resizes included; ``--trace`` replays it to the same
    master. Asserted on a 4 → 2 → 3 plan at capacity 4."""
    trace = str(tmp_path / "run.jsonl")
    args = ["--device", "cpu", "--rounds", "5", "--batch-size", "4",
            "--workers", "4", "--membership-plan", "2:2,4:3",
            "--comm-mode", "fused"]
    sess, records = ttrain.main(args + ["--dump-trace", trace,
                                        "--controller", "rules"])
    assert [r.num_active for r in records] == [4, 4, 2, 2, 3]
    replay, _ = ttrain.main(["--device", "cpu", "--batch-size", "4",
                             "--comm-mode", "fused", "--trace", trace])
    assert "coercing rounds/capacity to the recorded (5, 4)" in \
        capsys.readouterr().out
    assert torch.equal(replay.state["master"], sess.state["master"])
    assert replay.schedule.active.tolist() == sess.schedule.active.tolist()


def test_lm_training_is_refused_by_name():
    """LM training on the dense and MoE families runs through the CLI (one
    round of qwen3-4b SMOKE here; tests/test_torch_lm_session.py and
    tests/test_torch_moe_session.py hold them to the reference); the LM
    families the port lacks are still refused by name, and so is an
    encoder-decoder, whose source frames the LM data lacks."""
    sess, records = ttrain.main([
        "--device", "cpu", "--arch", "qwen3-4b", "--smoke", "--rounds", "1",
        "--workers", "2", "--seq-len", "16", "--batch-size", "2"])
    assert sess.model_cfg.name == "qwen3-smoke" and sess.spec.seq_len == 16
    assert len(records) == 1 and np.isfinite(records[0].loss)
    for arch, match in (("rwkv6-3b", "rwkv6-3b"), ("zamba2-7b", "zamba2-7b"),
                        ("seamless-m4t-large-v2", "seamless-smoke.*'src'")):
        with pytest.raises(NotImplementedError, match=match):
            ttrain.main(["--device", "cpu", "--arch", arch, "--smoke",
                         "--rounds", "1"])
