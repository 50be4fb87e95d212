"""Multi-process start-up and process-level helpers (port of
``obia_tpu/parallel/distributed.py``) over ``torch.distributed``.

:func:`initialize` starts the process group when the caller names one
(``coordinator_address`` / ``num_processes``) or a cluster manager says
there is one (torchrun's ``WORLD_SIZE``, Slurm, Open MPI, PMI), and is a
no-op on one process and when already initialised. A mesh made with
``parallel.mesh.make_mesh(..., distributed=True)`` then puts one shard row
on each rank.

The backend: NCCL when every rank has a card of its own (no more ranks on
a node than the node has cards), gloo on the CPU; several ranks sharing a
card must ask for ``backend="gloo"``, since NCCL refuses two ranks on one
GPU.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# a value > 1 in any of these means a multi-process cluster (torchrun's,
# and those of JAX's _cluster_env_present)
_CLUSTER_VARS = ("WORLD_SIZE", "SLURM_NTASKS", "SLURM_JOB_NUM_NODES",
                 "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")
_WORLD_VARS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE",
               "PMI_SIZE")
_RANK_VARS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "PMI_RANK")
# this node's share of the ranks, and a rank's place among them
_LOCAL_WORLD_VARS = ("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE",
                     "OMPI_COMM_WORLD_LOCAL_SIZE")
_LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID",
                    "OMPI_COMM_WORLD_LOCAL_RANK")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 60.0) -> None:
    """Start the process group. ``coordinator_address`` is rank 0's
    ``host:port``; without it the address comes from ``MASTER_ADDR`` and
    ``MASTER_PORT``. ``num_processes`` and ``process_id`` default to the
    cluster manager's variables. ``backend`` defaults to NCCL when every
    rank has a card of its own, that is when the ranks on this node (the
    launcher's local size, else all of them) are no more than its cards
    (``torch.cuda.set_device(local_rank)`` first), and to gloo where there
    is no card, and raises otherwise.

    Nothing here initialises CUDA before the process group exists (a
    context made on card 0 first would sit in every rank)."""
    if dist.is_initialized():
        return
    if (coordinator_address is None and num_processes is None
            and not _cluster_env_present()):
        return
    world = num_processes if num_processes is not None else _env_int(
        _WORLD_VARS)
    rank = process_id if process_id is not None else _env_int(_RANK_VARS)
    if world is None or rank is None:
        raise ValueError("a process group needs num_processes and "
                         "process_id, or a cluster manager that sets them")
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ:
        init_method = "env://"
    else:
        raise ValueError("no coordinator: pass coordinator_address="
                         "'host:port' or set MASTER_ADDR and MASTER_PORT")
    local_world = _env_int(_LOCAL_WORLD_VARS)
    backend = backend or _default_backend(
        world if local_world is None else local_world)
    if backend == "nccl":
        local_rank = _env_int(_LOCAL_RANK_VARS)
        torch.cuda.set_device(rank if local_rank is None else local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _default_backend(local_world: int) -> str:
    """The backend for ``local_world`` ranks on this node."""
    cards = torch.cuda.device_count()  # counts; creates no context
    if cards == 0:
        return "gloo"
    if local_world <= cards:
        return "nccl"
    raise RuntimeError(
        f"{local_world} ranks on {cards} card(s) of this node: NCCL refuses "
        f"two ranks on one GPU; pass backend='gloo' to share a card")


def _env_int(names: Sequence[str]) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def _cluster_env_present() -> bool:
    """True under a multi-process launcher or cluster manager; single-task
    allocations stay no-op."""
    for var in _CLUSTER_VARS:
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            continue
    return False


def process_info() -> dict:
    """This process's index and the group's size; ``local_devices`` is
    the devices this process computes on (one card a rank under NCCL, the
    visible cards or the CPU otherwise) and ``global_devices`` the
    distinct ones over the ranks: a card that several ranks share counts
    once, each rank's CPU counts as its own. In a process group this is a
    collective: every rank calls it."""
    if not dist.is_initialized():
        local = max(torch.cuda.device_count(), 1)
        return {"process_index": 0, "process_count": 1,
                "local_devices": local, "global_devices": local}
    rank = dist.get_rank()
    if dist.get_backend() == "nccl":
        cards = [torch.cuda.current_device()]
    else:
        cards = range(torch.cuda.device_count())
    host = socket.gethostname()
    mine = [(host, str(torch.cuda.get_device_properties(i).uuid))
            for i in cards] or [(host, f"cpu of rank {rank}")]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {"process_index": rank, "process_count": dist.get_world_size(),
            "local_devices": len(mine),
            "global_devices": len({d for ds in every for d in ds})}


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
