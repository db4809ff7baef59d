"""Process-group setup and the per-rank data feed (the JAX package's
``parallel/multihost.py``).

Every rank is one process on one device.  ``initialize`` starts the
default process group from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or from explicit
arguments (tests give a ``file://`` store in a directory of their own).
The backend follows from the devices asked for (``backend_for``), never
from a probe that falls back: gloo on the CPU, NCCL where each rank has
its own card, gloo where ranks share one card.

Only the primary (rank 0) writes checkpoints, logs and artifacts; every
rank reads them.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deepmetv2_tpu_torch.data.batching import EventBatch, to_device

TIMEOUT = datetime.timedelta(minutes=10)


def rank_devices(device, world: int) -> List[torch.device]:
    """The device of each of ``world`` ranks for a requested ``device``:
    the CPU for every rank; for CUDA, one card per rank (``cuda:r``) where
    there are enough, else all ranks on the requested card."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * world
    if world > 1 and torch.cuda.device_count() >= world:
        return [torch.device("cuda", r) for r in range(world)]
    return [torch.device("cuda", device.index or 0)] * world


def backend_for(devices: Sequence[torch.device]) -> str:
    """'nccl' when every rank has a card of its own, else 'gloo' (the CPU,
    or ranks sharing a card: NCCL refuses two ranks on one device)."""
    if (all(d.type == "cuda" for d in devices)
            and len(set(devices)) == len(devices)):
        return "nccl"
    return "gloo"


def from_environment() -> bool:
    """True under torchrun (or any launcher that sets RANK and
    WORLD_SIZE)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device=None) -> None:
    """``init_process_group`` with an explicit backend: from torchrun's
    environment when ``init_method`` is None, else from ``init_method``,
    ``world_size`` and ``rank``.  A CUDA ``device`` becomes this process's
    current device (NCCL and ``all_gather_object`` need it)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    if init_method is None:
        dist.init_process_group(backend, timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=TIMEOUT)


def environment_rank() -> Tuple[int, int, int]:
    """(rank, world size, local rank) from torchrun's environment."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return rank, world, int(os.environ.get("LOCAL_RANK", rank))


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and artifacts:
    rank 0, or the only process when no group is set up."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_to_global(local_batch: EventBatch, mesh) -> EventBatch:
    """This rank's own events as its rows of the global batch: rank ``r``
    of a data-parallel mesh owns rows ``[r·B_local, (r+1)·B_local)`` of a
    batch of ``B_local·D`` events, the rank order of the mesh, as in the
    JAX package.  Every rank must pass the same shapes (checked here);
    returns the local batch on the mesh's device."""
    if mesh.n_node != 1:
        raise ValueError("local_batch_to_global feeds a data-parallel mesh "
                         "(n_node == 1)")
    shape = torch.tensor([s for f in local_batch for s in f.shape])
    shapes = mesh.all_gather(shape.to(mesh.device))
    if any(not torch.equal(s.cpu(), shape) for s in shapes):
        raise ValueError("ranks hold local batches of different shapes: "
                         f"{[s.tolist() for s in shapes]}")
    return to_device(local_batch, mesh.device)
