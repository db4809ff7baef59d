"""The node-sharded DRN (the JAX package's ``parallel/dyn.py``): events
shard over the mesh's ``data`` axis and each event's padded node axis over
``node`` (parallel/mesh.py:shard_batch with ``shard_nodes``); the
DynamicReductionNetwork forward runs on each rank's node shard.

Each round, through the hooks of models/drn.py:drn_apply:

1. the distributed kNN build (parallel/knn.py): the all-gather build, or
   the ring build with ``DRNConfig.ring_knn``; global neighbour indices;
2. what GSPMD does implicitly in the JAX package, written out
   (``NodeShards``): ``to_undirected`` needs every rank's lists, the conv
   (the fused edge-MLP conv, a ``pallas_call`` with no SPMD rule, which
   the sharded trace replicates on a TPU) reads every row, the matching
   pairs nodes across shards, the pooling moves a partner's features
   across shards and the per-event max pool spans every row.  So the
   round's lists, features and mask are all-gathered over the node group,
   the port's single-device ops (ops/graph.py:to_undirected,
   models/drn.py:_drn_edgeconv, ops/coarsen.py) run on the whole axis on
   every rank alike, and each rank keeps its rows.  Gradients return
   through the all-gathers' reduce-scatter
   (parallel/collectives.py:gather_nodes).

The conv is models/drn.py:_drn_edgeconv's choice, the fused conv's
kernels (ops/cuda/edge_mlp.py: ``edge_mlp_fwd``, in training
``edge_mlp_bwd``) at the shapes they take, as on a TPU.  Its edge
BatchNorm statistics in training sum over the data group
(``NodeShards.whole_axis``: every rank of a node group holds the same
whole axis); there is no compaction between rounds.

The train step: every rank of a node group holds the same pooled output
and loss, so each back-propagates its share with weight 1/N (as
parallel/ep.py does for GraphMET); the gradients summed over every rank
after ``backward`` are the global batch's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deepmetv2_tpu_torch.config import Config, DRNConfig
from deepmetv2_tpu_torch.data.batching import EventBatch
from deepmetv2_tpu_torch.models.drn import drn_apply, drn_net_apply
from deepmetv2_tpu_torch.parallel import context as pctx
from deepmetv2_tpu_torch.parallel.collectives import gather_nodes
from deepmetv2_tpu_torch.parallel.dp import event_share, mesh_step
from deepmetv2_tpu_torch.parallel.knn import (knn_graph_sharded,
                                              knn_graph_sharded_ring)
from deepmetv2_tpu_torch.train.loss import drn_per_event, real_event_total


class NodeShards:
    """The node layout of a rank of ``mesh``'s node group (the ``nodes``
    hook of models/drn.py:drn_apply): ``gather`` all-gathers a node shard
    into the whole axis (differentiable for floats), ``local`` keeps this
    rank's rows ``[n·n_loc, (n+1)·n_loc)`` of a whole axis, and in
    ``whole_axis()`` batch statistics sum over the data group only (the
    node group's ranks hold the same whole axis)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_nodes(t, self.mesh)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        n_loc = t.shape[1] // self.mesh.n_node
        i = self.mesh.node_index
        return t[:, i * n_loc:(i + 1) * n_loc]

    def whole_axis(self):
        return pctx.data_parallel(self.mesh)


def _hooks(cfg: DRNConfig, mesh, ring: bool) -> dict:
    """drn_apply's hooks for ``mesh``: the kNN build (the ring build with
    ``ring``) and the node layout."""
    build = knn_graph_sharded_ring if ring else knn_graph_sharded
    return dict(knn_fn=lambda h, m: build(h, m, k=cfg.k, mesh=mesh),
                nodes=NodeShards(mesh))


def drn_apply_sharded(model, x: torch.Tensor, mask: torch.Tensor, mesh,
                      ring: bool = False, diag: Optional[dict] = None
                      ) -> torch.Tensor:
    """The node-sharded DRN forward of this rank's shard ``x [B, n_loc,
    input_dim]``, ``mask [B, n_loc]``: per-event outputs ``[B,
    output_dim]``, the same on every rank of the node group.  In training
    mode the edge BatchNorm statistics are the global batch's.  ``diag``
    as in drn_apply (its rounds hold the whole axis's decisions)."""
    with pctx.edge_partitioning(mesh):
        return drn_apply(model, x, mask, diag,
                         **_hooks(model.cfg, mesh, ring))


def drn_net_apply_sharded(model, batch: EventBatch, mesh, ring: bool = False,
                          diag: Optional[dict] = None) -> torch.Tensor:
    """``drn_apply_sharded`` with the output head (models/drn.py:
    drn_net_apply) on this rank's node shard of ``batch``."""
    with pctx.edge_partitioning(mesh):
        return drn_net_apply(model, batch, diag,
                             **_hooks(model.cfg, mesh, ring))


def drn_ep_objective(cfg: Config, mesh) -> Callable:
    """``(model, node shard) -> (share, loss part)``: the share is this
    rank's part of the event mean with weight 1/N, the loss part the same
    without it (summed over the data group it is the global loss)."""

    def objective(model, batch: EventBatch):
        pred = drn_net_apply_sharded(model, batch, mesh, cfg.drn.ring_knn)
        part = event_share(*real_event_total(
            drn_per_event(pred, batch, cfg.drn.head), batch), mesh)
        return part / mesh.n_node, part

    return objective


def make_drn_ep_train_step(cfg: Config, mesh) -> Callable:
    """The node-sharded DRN train step ``(model, optimizer, node shard) ->
    global loss``: BatchNorm statistics and gradients over every rank, the
    kNN build by ``cfg.drn.ring_knn``."""
    return mesh_step(cfg, mesh, drn_ep_objective(cfg, mesh),
                     pctx.edge_partitioning, None)
