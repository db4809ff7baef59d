"""The mesh step's context (the JAX package's ``parallel/context.py``):
which mesh the current step runs on, and how.

``with data_parallel(mesh):`` — each rank runs the single-device model on
its own events: the window EdgeConv's kernels run per rank, and the masked
BatchNorm statistics in training mode are sums over the ranks that hold
the global batch (the mesh's data group), as GSPMD makes them in the JAX
package's data-parallel steps (``parallel/dp.py:8-11``).

``with edge_partitioning(mesh):`` — the counterpart of the JAX
``edge_partitioning`` (``context.py:36-45``): ``ops/edgeconv.py:edgeconv``
sends the window 'max' aggregation through the halo-exchange path
(parallel/halo.py), and BatchNorm statistics are sums over every rank.

Both force float32 compute: the JAX mesh steps compute f32 whatever
``compute_dtype`` says (its window twin and its sharded path take no
dtype).  The JAX ``force_xla_window`` has no counterpart: the port's mesh
steps run the window kernels per rank instead of a twin.

The context is per thread and entered by the step around its forward; the
backward needs none (the collectives' autograd nodes hold their mesh).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional

import torch

_TLS = threading.local()


class MeshContext(NamedTuple):
    mesh: object
    stats_group: object          # the group BatchNorm statistics sum over
    edge_partitioned: bool


def current() -> Optional[MeshContext]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def _enter(ctx: MeshContext):
    prev = current()
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def data_parallel(mesh):
    """Batch statistics over the data group; the window max per rank."""
    return _enter(MeshContext(mesh, mesh.data_group, False))


def edge_partitioning(mesh):
    """Batch statistics over every rank; the window max through the halo
    exchange."""
    return _enter(MeshContext(mesh, None, True))


def batch_sum() -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The differentiable sum over the ranks that hold the global batch,
    for BatchNorm statistics, or None outside a mesh step (the local sum
    is the batch's)."""
    ctx = current()
    if ctx is None:
        return None
    from deepmetv2_tpu_torch.parallel.collectives import all_reduce_sum

    return lambda t: all_reduce_sum(t, ctx.mesh, ctx.stats_group)
