"""The device mesh (the JAX package's ``parallel/mesh.py``): a grid of
``torch.distributed`` ranks with a ``data`` axis (events) and a ``node``
axis (the padded node axis of each event, in edge-partitioned training).

The grid is in the rank order of the JAX package's ``make_mesh``: rank
``r = d·N + n`` sits at data index ``d`` and node index ``n``.  Every rank
holds one process group per data row (``node_group``: the N ranks that
split the same events' nodes) and one per node column (``data_group``:
the D ranks that hold different events at the same node shard).  Each
rank runs on one device, ``device``.

Collectives go through the mesh's ``all_reduce`` and ``all_gather``.  The
backend is chosen by ``multihost.backend_for`` from the ranks' devices:
gloo on the CPU, NCCL where every rank has its own card, and gloo where
ranks share one card (NCCL refuses two ranks on one device).  gloo takes
only some collectives on CUDA tensors, so on that backend with CUDA
tensors (``staged``) every collective goes through explicit host copies.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from deepmetv2_tpu_torch.data.batching import EventBatch


class Mesh:
    """The (data, node) grid of the default process group's ranks, seen
    from this rank.  Every rank must construct it, with the same shape, at
    the same point: the constructor creates the row and column groups."""

    def __init__(self, n_data: int, n_node: int = 1, device=None):
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data < 1 or n_node < 1 or n_data * n_node != world:
            raise ValueError(f"mesh {n_data}x{n_node} needs {n_data * n_node} "
                             f"ranks; the process group has {world}")
        self.n_data, self.n_node = n_data, n_node
        self.rank, self.world = rank, world
        self.data_index, self.node_index = divmod(rank, n_node)
        self.device = torch.device(device if device is not None else "cpu")
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        # every rank creates every group, in the same order
        self.node_group = self.data_group = None
        for d in range(n_data):
            g = dist.new_group([d * n_node + n for n in range(n_node)])
            if d == self.data_index:
                self.node_group = g
        for n in range(n_node):
            g = dist.new_group([d * n_node + n for d in range(n_data)])
            if n == self.node_index:
                self.data_group = g

    def describe(self) -> str:
        """One line: the grid, the backend and how collectives travel."""
        how = (f"collectives staged through host copies (the ranks share "
               f"{self.device})" if self.staged else "collectives on the "
               f"{'devices' if self.device.type == 'cuda' else 'CPU'}")
        return (f"{self.n_data} data x {self.n_node} node over {self.world} "
                f"ranks, backend {self.backend}, {how}")

    def all_reduce(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """Sum ``t`` over ``group`` (None: every rank), in place; returns
        ``t``."""
        if self.staged:
            h = t.detach().cpu()
            dist.all_reduce(h, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, group=None) -> List[torch.Tensor]:
        """``t`` of every rank of ``group`` (None: every rank), in the
        group's rank order."""
        n = dist.get_world_size(group)
        src = t.detach().contiguous()
        if self.staged:
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=group)
        return [o.to(t.device) for o in out]


def _slice(a, axis: int, index: int, parts: int, what: str):
    size = a.shape[axis]
    if size % parts:
        raise ValueError(f"{what} axis of {size} does not split into "
                         f"{parts} shards")
    k = size // parts
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(index * k, (index + 1) * k)
    return a[tuple(sl)]


def shard_batch(batch: EventBatch, mesh: Mesh, shard_nodes: bool = False,
                chained: bool = False) -> EventBatch:
    """This rank's slice of an ``EventBatch`` (numpy or torch): events
    ``[d·B/D, (d+1)·B/D)`` and, with ``shard_nodes``, nodes ``[n·Np/N,
    (n+1)·Np/N)`` of the padded node axis.  ``chained``: the batch is a
    stack of chained batches, whose event axis is the second."""
    e = 1 if chained else 0

    def one(f, nodes: bool):
        f = _slice(f, e, mesh.data_index, mesh.n_data, "event")
        if nodes and shard_nodes:
            f = _slice(f, e + 1, mesh.node_index, mesh.n_node, "node")
        return f

    return EventBatch(one(batch.x_cont, True), one(batch.x_cat, True),
                      one(batch.mask, True), one(batch.y, False),
                      one(batch.num_valid, False))
