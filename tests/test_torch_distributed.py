"""Sharded placement on a real two-rank ``torch.distributed`` group: two
gloo ranks on the CPU, spawned as processes of their own
(``tests/_torch_ranks.py``), run the port's session with the slot axis
split over them; the CLI's two-process run mirrors
tests/test_distributed.py on a real group.

Bit-exactness, as measured on the CPU here (one torch thread per
process): every rank's master, ``master_prev``, u-history, sub-masters
and rack u-histories are bit-identical to one another and to single
placement, and so are the gathered worker rows and optimizer state. The
comm phase is the same arithmetic on the same gathered buffer, and the
local phase's ``vmap(jvp(grad))`` over a rank's 2-4 workers gives the
bits it gives over all of them. The one value that may differ is the
round's mean loss: each rank sums its own (worker, step) losses and an
``all_reduce`` adds the partial sums, a different association than one
sum over every slot, so it is held to rtol 1e-6 (a few ulps of float32).
"""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro.checkpoint import checkpoint as rck
from repro_torch.api.session import ElasticSession
from repro_torch.checkpoint import checkpoint as tck
from test_torch_session import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE = ("master", "master_prev", "u_hist", "submasters", "g_u_hist",
         "workers", "opt/count", "opt/m", "opt/v")


def _singles():
    """Every scenario at single placement, one torch thread: (capacity,
    summary) by name."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name in ranks.SCENARIOS:
            sess = ElasticSession(ranks.spec(name, "single"))
            out[name] = sess.capacity, ranks.summary(sess, ranks.run(sess))
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every scenario of ``_torch_ranks.sessions`` on two gloo ranks, and
    at single placement here while they run: what each rank saw, the
    directory of the flat run's checkpoint, the single-placement runs."""
    out = str(tmp_path_factory.mktemp("ranks"))
    results, singles = ranks.spawn(ranks.sessions, 2, out, _singles)
    return results, out, singles


def _check_scenario(two_ranks, name):
    """Both ranks' state bit-identical to each other and to single
    placement's, every record equal (the mean loss to rtol 1e-6)."""
    got = [r[name] for r in two_ranks[0]]
    cap, want = two_ranks[2][name]
    assert [g["rows"] for g in got] == [(0, cap // 2), (cap // 2, cap)]
    for key in STATE:
        if key not in want:
            continue
        for rank, g in enumerate(got):
            assert torch.equal(g[key], want[key]), f"rank {rank} {key}"
    for key in want:
        if not key.startswith("rec/"):
            continue
        for rank, g in enumerate(got):
            a, b = g[key], want[key]
            if key == "rec/loss":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                           err_msg=f"rank {rank} {key}")
                assert g[key] == got[0][key]  # ranks agree bit for bit
            else:
                assert all(np.array_equal(x, y) for x, y in zip(a, b)), \
                    f"rank {rank} {key}"
    return got, want


def test_flat_fused_masters_agree_across_ranks_and_with_single(two_ranks):
    """4 workers over 2 ranks, DEAHES-O fused, τ=2, 2 rounds under iid
    failures."""
    got, want = _check_scenario(two_ranks, "flat")
    assert any(not h2.all() for h2 in want["rec/h2"])  # some fail rounds


def test_hierarchy_with_a_rack_straddling_the_ranks(two_ranks):
    """7 workers padded to 8 slots over 2 ranks, racks of 3/3/2 (rack 1 on
    both ranks), a global sync every 2 rounds: masters and sub-masters
    bit-identical everywhere; the padded slot stays vacant; g_h2 non-zero
    on the sync rounds only."""
    got, want = _check_scenario(two_ranks, "hier")
    assert want["submasters"].shape[0] == 3
    assert all(a.tolist() == [True] * 7 + [False]
               for a in got[1]["rec/active"])
    assert [bool(np.any(g)) for g in got[0]["rec/g_h2"]] == [
        r % 2 == 1 for r in range(ranks.ROUNDS["hier"])]


def test_membership_join_mid_run(two_ranks):
    """3 of 6 slots live (the second rank holds none), resized to 5 at round
    2: slots 3-4, on the second rank, join from the master."""
    got, _ = _check_scenario(two_ranks, "join")
    live = [int(a.sum()) for a in got[1]["rec/active"]]
    assert live == [3] * ranks.JOIN_AT + [ranks.JOIN_TO] * (
        ranks.ROUNDS["join"] - ranks.JOIN_AT)
    assert not got[1]["rec/h2"][0][3:].any()


def test_checkpoint_written_by_rank_0_only_read_by_both_packages(two_ranks):
    """The flat run's ``save``, called on both ranks: rank 0 wrote it, rank 1
    wrote nothing; a single-placement session and the reference's
    ``restore`` read the ranks' master back bit for bit."""
    results, out, _ = two_ranks
    path = os.path.join(out, "ck")
    assert results[0]["writes"] == [path] and results[1]["writes"] == []
    master = results[0]["flat"]["master"]
    warm = ElasticSession(ranks.spec("flat", "single"))
    meta = warm.restore(path)
    assert torch.equal(warm.state["master"], master)
    assert meta["rounds"] == ranks.ROUNDS["flat"]
    assert np.array_equal(meta["elastic"]["active"], [True] * 4)
    tree, _ = rck.restore(path)
    assert torch.equal(warm.layout.pack_tree(tree), master)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_two_process_smoke_agrees(tmp_path):
    """``launch/train.py`` as two processes on one gloo group (hierarchy,
    sharded, ``--save``): both ranks print the same final master l2, only
    rank 0 prints round lines, the checkpoint restores to that master."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port, ck = _free_port(), str(tmp_path / "ck")
    argv = ["--device", "cpu", "--rounds", "2", "--workers", "4", "--tau",
            "1", "--batch-size", "4", "--optimizer", "sgd", "--comm-mode",
            "fused", "--placement",
            "sharded", "--groups", "2", "--global-period", "2",
            "--coordinator-address", f"127.0.0.1:{port}", "--num-processes",
            "2", "--save", ck]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--process-id", str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        finally:
            p.kill()
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    l2s = [re.search(r"final master l2=([0-9.e+-]+)", out).group(1)
           for out in outs]
    assert l2s[0] == l2s[1] and 0 < float(l2s[0]) < 1e6
    for i, out in enumerate(outs):
        assert f"[mesh] rank {i} of 2: backend gloo on cpu" in out
    assert outs[0].count("round ") == 2 and "g_h2=" in outs[0]
    assert "round " not in outs[1] and "g_h2" not in outs[1]
    assert f"saved master params to {ck}" in outs[0]
    warm = ElasticSession(ranks.spec("flat", "single"))
    warm.restore(ck)
    l2 = float(torch.linalg.vector_norm(warm.state["master"].double()))
    assert f"{l2:.10e}" == l2s[0]
    assert tck.read_metadata(ck)["elastic"]["groups"] == 2
