"""The edge-partitioned GraphMET train step (the JAX package's
``parallel/ep.py``): events shard over the mesh's ``data`` axis and each
event's padded node axis over ``node`` (parallel/mesh.py:shard_batch with
``shard_nodes``).  The window 'max' EdgeConvs run through the halo
exchange (parallel/halo.py, entered by parallel/context.py:
edge_partitioning); per-node layers need nothing; BatchNorm statistics
are sums over every rank; each event's METx and METy are summed over its
node group by the differentiable all-reduce before the loss squares them.

All N ranks of a node group then hold the same per-event loss, so each
counts it with weight 1/N: the shares sum to the global loss over the
world, and the gradients, summed over every rank after ``backward``, are
the global batch's (without the weight they would be N times too large).

The batch must come sorted from the host (``graph.presorted``; the CLI
sorts in eta order by default for such runs, or in cell order), because
a rank sees only its node shard; the halo is the whole batch's required
span, sized on the host before sharding.  Window mode is forced, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from deepmetv2_tpu_torch.config import Config
from deepmetv2_tpu_torch.data.batching import EventBatch
from deepmetv2_tpu_torch.models.graph_met import net_apply
from deepmetv2_tpu_torch.parallel import context as pctx
from deepmetv2_tpu_torch.parallel.collectives import all_reduce_sum
from deepmetv2_tpu_torch.parallel.dp import event_share, mesh_step
from deepmetv2_tpu_torch.train.loss import (met_per_event, real_event_total,
                                            weighted_met)
from deepmetv2_tpu_torch.train.step import window_graph


def ep_config(cfg: Config) -> Config:
    """``cfg`` in window mode, and checked for host-sorted batches."""
    if not cfg.graph.presorted:
        raise ValueError("edge partitioning needs batches sorted on the host "
                         "before node sharding (graph.presorted): a rank "
                         "holds only its node shard")
    if cfg.graph.mode != "window":
        cfg = dataclasses.replace(
            cfg, graph=dataclasses.replace(cfg.graph, mode="window"))
    return cfg


def ep_objective(cfg: Config, mesh) -> Callable:
    """``(model, node shard) -> (share, loss part)``: the share is the
    event mean's part of this rank with weight 1/N, the loss part the same
    without it (summed over the data group it is the global loss)."""
    cfg = ep_config(cfg)

    def objective(model, batch: EventBatch):
        w = net_apply(model, batch, window_graph(batch, cfg))
        metx, mety = weighted_met(w, batch)
        metx = all_reduce_sum(metx, mesh, mesh.node_group)
        mety = all_reduce_sum(mety, mesh, mesh.node_group)
        part = event_share(*real_event_total(
            met_per_event(metx, mety, batch), batch), mesh)
        return part / mesh.n_node, part

    return objective


def make_ep_train_step(cfg: Config, mesh) -> Callable:
    """The edge-partitioned train step ``(model, optimizer, node shard) ->
    global loss``: BatchNorm statistics and gradients over every rank."""
    return mesh_step(cfg, mesh, ep_objective(cfg, mesh),
                     pctx.edge_partitioning, None)
