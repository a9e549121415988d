"""Rank bodies for tests/test_torch_distributed.py: each runs in a process
of its own, spawned per rank, and imports torch, numpy and the port only
(no JAX), so a rank starts in about two seconds.

:func:`spawn` starts ``world`` ranks that join one gloo group through a
``file://`` store (no TCP port to collide between test workers), each with
one torch thread, and runs ``fn(rank, out_dir)`` in every one.
"""
from __future__ import annotations

import os

import torch
import torch.multiprocessing as mp

from repro_torch.api.session import ElasticSession, RunSpec
from repro_torch.checkpoint import checkpoint
from repro_torch.configs.base import ElasticConfig, OptimizerConfig
from repro_torch.control.actions import ControlAction
from repro_torch.launch.mesh import gather_rows, init_distributed

SCENARIOS = ("flat", "hier", "join")
ROUNDS = {"flat": 2, "hier": 4, "join": 3}
JOIN_AT, JOIN_TO = 2, 5  # the join scenario's resize: round, live count


def spec(name: str, placement: str) -> RunSpec:
    """The runs both placements make: ``flat`` (DEAHES-O: AdaHessian, 4
    workers, fused, τ=2), ``hier`` (7 workers in 3 racks, a global sync
    every 2 rounds; sharded placement pads the capacity to 8, single
    placement is given capacity 8, so both split 3/3/2 and rack 1 — slots
    3-5 — straddles two ranks) and ``join`` (3 of 6 slots live, so the
    second rank starts with no live slot; 5 live from round 2). The last
    two train with SGD at τ=1, to keep the file quick."""
    ekw = dict(num_workers=4, tau=2, comm_mode="fused", placement=placement)
    opt = "adahessian"
    if name == "hier":
        ekw.update(num_workers=7, groups=3, global_period=2, tau=1,
                   capacity=8 if placement == "single" else 0)
        opt = "sgd"
    elif name == "join":
        ekw.update(num_workers=3, capacity=6, tau=1)
        opt = "sgd"
    return RunSpec(optimizer=OptimizerConfig(name=opt),
                   elastic=ElasticConfig(**ekw), rounds=ROUNDS[name],
                   batch_size=4, n_data=200, n_test=16, eval_every=2,
                   device="cpu")


def run(sess: ElasticSession):
    """Run ``sess`` to its end (the join scenario resizes at ``JOIN_AT``);
    returns its records."""
    if sess.spec.elastic.capacity != 6:
        return sess.run()
    records = sess.run(JOIN_AT)
    sess.apply(ControlAction.resize(JOIN_TO))
    return records + sess.run()


def summary(sess: ElasticSession, records) -> dict:
    """What the tests compare: the replicated state, every slot's worker
    rows and optimizer state (gathered: a collective under sharding), and
    the records."""
    st = sess.state
    out = {key: st[key].clone() for key in ("master", "master_prev",
                                            "u_hist", "submasters",
                                            "g_u_hist") if key in st}
    out["workers"] = gather_rows(st["workers"]).clone()
    out.update({f"opt/{key}": gather_rows(val).clone()
                for key, val in st["opt"].items()})
    for key in ("loss", "u", "h2", "loss_w", "eval_loss", "g_h2", "active"):
        out[f"rec/{key}"] = [getattr(r, key) for r in records]
    return out


def sessions(rank: int, out_dir: str) -> None:
    """Every scenario at sharded placement; the flat run also saves (every
    rank calls ``save``, the checkpoint module's writes are counted)."""
    writes = []
    real_write = checkpoint._write
    checkpoint._write = lambda *a: (writes.append(a[0]), real_write(*a))[1]
    results = {}
    for name in SCENARIOS:
        sess = ElasticSession(spec(name, "sharded"))
        results[name] = summary(sess, run(sess))
        results[name]["rows"] = (sess.trainer._lo, sess.trainer._hi)
        if name == "flat":
            sess.save(os.path.join(out_dir, "ck"))
    results["writes"] = writes
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _entry(rank, fn, world, out_dir):
    torch.set_num_threads(1)
    init_distributed("file://" + os.path.join(out_dir, "store"), world, rank,
                     "cpu")
    try:
        fn(rank, out_dir)
    finally:
        torch.distributed.destroy_process_group()


def spawn(fn, world: int, out_dir: str, meanwhile=lambda: None):
    """Run ``fn(rank, out_dir)`` on ``world`` gloo ranks, and ``meanwhile()``
    here while they run; returns what each rank saved to
    ``out_dir/rank{r}.pt`` and what ``meanwhile`` returned."""
    ctx = mp.spawn(_entry, args=(fn, world, str(out_dir)), nprocs=world,
                   join=False)
    try:
        here = meanwhile()
    finally:
        while not ctx.join():
            pass
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)], here
