"""Process groups of the port's sharded placement (``repro.launch.mesh``'s
counterpart on ``torch.distributed``).

Sharded placement splits the worker-slot axis over the ranks of a process
group: rank r holds the contiguous slots :func:`shard_slots` gives it, the
master is replicated on every rank. One process per rank;
:func:`init_distributed` joins the group and picks the rank's device, and
:func:`gather_rows` is the one collective the round's comm phase needs.
Without an initialised group the sharded code runs at world size 1, where
the gather is the identity (the reference's pod=1 mesh).

Backends: ``nccl`` when every rank has a card of its own (``cuda:rank``);
``gloo`` when ranks share a card or run on the CPU (NCCL refuses two ranks
on one GPU). The TPU production meshes of the reference serve only its dry
run and are not ported here.
"""
from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# how long a rank waits for the others at a collective before it raises
TIMEOUT = datetime.timedelta(seconds=300)


def padded_capacity(capacity: int, world: int) -> int:
    """Smallest multiple of ``world`` >= ``capacity``: the slot axis splits
    evenly over the ranks, so a capacity that does not divide is padded up
    and the extra slots start vacant (ranks hold equal numbers of slots,
    not of live workers)."""
    return -(-capacity // world) * world


def shard_slots(cap: int, world: int, rank: int) -> Tuple[int, int]:
    """``(lo, hi)``: the contiguous slot range rank ``rank`` holds of
    ``cap`` slots split over ``world`` ranks (``cap`` a multiple of
    ``world``)."""
    if cap % world:
        raise ValueError(
            f"capacity {cap} does not split over {world} ranks; pad it "
            "with padded_capacity")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside 0..{world - 1}")
    per = cap // world
    return rank * per, (rank + 1) * per


def world_and_rank(group=None) -> Tuple[int, int]:
    """``(world size, rank)`` in ``group`` (None: the default group), or
    ``(1, 0)`` when no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def init_distributed(coordinator_address: Optional[str], num_processes: int,
                     process_id: int, device: str = "cuda") -> torch.device:
    """Join the default process group as rank ``process_id`` of
    ``num_processes`` and return the rank's device.

    ``coordinator_address`` is ``host:port`` of rank 0's store
    (``tcp://`` is implied) or a full init URL (``tcp://…``, ``file://…``).
    ``device="cuda"`` places rank r on ``cuda:r % device_count`` and makes
    it the current device; the backend is ``nccl`` when there are at least
    as many cards as ranks, else ``gloo`` (with CUDA tensors), and
    ``gloo`` on the CPU. The choice is printed. Joining an already
    initialised group of the same size and rank is a no-op."""
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0.."
                         f"{num_processes - 1}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but torch sees no CUDA device; pass "
                "device='cpu' to run the plain PyTorch path")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", process_id % n_cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if n_cards >= num_processes else "gloo"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if world_and_rank() != (num_processes, process_id):
            raise RuntimeError(
                f"a process group of {world_and_rank()} (world, rank) is "
                f"already initialised; asked for ({num_processes}, "
                f"{process_id})")
        return dev
    if not coordinator_address:
        raise ValueError("a process group needs a coordinator address "
                         "(host:port of rank 0)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    print(f"[mesh] rank {process_id} of {num_processes}: backend {backend} "
          f"on {dev}", flush=True)
    return dev


def gather_rows(local: torch.Tensor, group=None) -> torch.Tensor:
    """All ranks' row blocks, in rank order: ``local`` (rows, …) on every
    rank becomes (world·rows, …), bit for bit, on every rank. At world
    size 1 (or with no group initialised) ``local`` itself."""
    world, _ = world_and_rank(group)
    if world == 1:
        return local
    # gloo takes CUDA tensors here too (measured bit-exact on the card); a
    # zero-filled all_reduce would turn -0.0 into +0.0
    local = local.contiguous()
    out = local.new_empty((world * local.shape[0], *local.shape[1:]))
    dist.all_gather(list(out.chunk(world)), local, group=group)
    return out


def max_over_ranks(values, device, group=None):
    """The element-wise maximum of the float ``values`` over all ranks (a
    list of Python floats; returned as one). At world size 1, ``values``."""
    if world_and_rank(group)[0] == 1:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()
