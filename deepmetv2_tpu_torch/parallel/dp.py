"""Data-parallel train and evaluation steps for both families (the JAX
package's ``parallel/dp.py``), and the mesh step they share with the
edge-partitioned one (parallel/ep.py).

Events shard over the mesh's ``data`` axis (parallel/mesh.py:shard_batch);
parameters and AdamW state are replicated, every rank starting from the
same state and applying the same summed gradient.  In a step:

* masked BatchNorm statistics are the global batch's (nn/core.py:
  masked_moments under parallel/context.py:data_parallel), as GSPMD makes
  them in the JAX steps; the running buffers take the global n;
* the loss counts each event once: rank r's objective is its share
  ``0.5 · Σ_local per_event / n_events_global`` (the event count a plain
  all-reduce), so the shares sum to the global loss; gradients are summed
  over the ranks after ``backward`` (one all-reduce of the flattened
  gradients) and the global loss is reported from a detached all-reduce.
  (Back-propagating the all-reduced global loss on every rank would make
  each gradient D times too large.)
* GraphMET runs the single-device model on each rank's events, so the
  window kernels run per rank.  The JAX steps take the window's XLA twin
  instead (``force_xla_window``): the forward is the same; the gradient
  differs only where a query has exactly tied sources (the kernels give
  each tied source the full gradient, autodiff's rule does not; ROADMAP
  "Known divergences").
* The DRN follows the JAX mesh path: the composed graph build and the
  gather-reduce conv (``graph_force='composed', conv_force='xla'``), which
  is what ``force_xla_window`` selects in the JAX package.
* compute is float32 whatever ``compute_dtype`` says, as in the JAX mesh
  steps.

Evaluation is data parallel too: the batch is padded with empty events to
a multiple of D, each rank evaluates its rows, and the MET vectors (and
GraphMET's weights) are gathered on every rank of the data group; padded
events change nothing.  On a D×N mesh evaluation shards over ``data``
only, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.config import Config
from deepmetv2_tpu_torch.data.batching import (EventBatch, pad_batch_events,
                                               to_device)
from deepmetv2_tpu_torch.models.drn import drn_net_apply
from deepmetv2_tpu_torch.models.graph_met import net_apply
from deepmetv2_tpu_torch.parallel import context as pctx
from deepmetv2_tpu_torch.parallel.collectives import gather_rows
from deepmetv2_tpu_torch.parallel.mesh import shard_batch
from deepmetv2_tpu_torch.train.loss import (drn_met_vector, drn_per_event,
                                            met_per_event, real_event_total,
                                            weighted_met)
from deepmetv2_tpu_torch.train.family import DEFAULT, mesh_forms
from deepmetv2_tpu_torch.train.step import build_graph, clip_by_global_norm

# The DRN's forms on a mesh: those the JAX package's force_xla_window picks
DRN_MESH_FORCES = dict(graph_force="composed", conv_force="xla")


@torch.no_grad()
def sum_gradients(params, mesh, group) -> None:
    """Replace every gradient by its sum over ``group``: one all-reduce of
    the flattened gradients."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def event_share(total: torch.Tensor, n_local: torch.Tensor, mesh
                ) -> torch.Tensor:
    """``0.5 · total / n_events_global``: this rank's share of the mean over
    the global batch's real events (their count summed over the data
    group, no gradient)."""
    n = mesh.all_reduce(n_local.clone(), mesh.data_group)
    return 0.5 * total / torch.clamp(n, min=1)


def mesh_step(cfg: Config, mesh, objective: Callable, context: Callable,
              grad_group) -> Callable:
    """``(model, optimizer, local batch) -> global loss`` around
    ``objective(model, batch) -> (share, loss part)``: the forward under
    ``context(mesh)``, ``share.backward()``, the gradients summed over
    ``grad_group``, the optional global-norm clip, the AdamW step; the
    loss parts summed over the data group are the global loss before the
    update (a detached device scalar)."""
    clip = cfg.optim.grad_clip_norm

    def train_step(model, optimizer, batch: EventBatch) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with context(mesh):
            share, part = objective(model, batch)
        share.backward()
        sum_gradients(model.parameters(), mesh, grad_group)
        if clip is not None:
            clip_by_global_norm(model.parameters(), clip)
        optimizer.step()
        return mesh.all_reduce(part.detach().clone(), mesh.data_group)

    return train_step


def graphmet_dp_objective(cfg: Config, mesh) -> Callable:
    """GraphMET's ``(model, local batch) -> (share, share)``."""

    def objective(model, batch: EventBatch):
        batch, graph = build_graph(batch, cfg)
        w = net_apply(model, batch, graph)
        share = event_share(*real_event_total(
            met_per_event(*weighted_met(w, batch), batch), batch), mesh)
        return share, share

    return objective


def drn_dp_objective(cfg: Config, mesh) -> Callable:
    """The DRN's ``(model, local batch) -> (share, share)``."""

    def objective(model, batch: EventBatch):
        pred = drn_net_apply(model, batch, **DRN_MESH_FORCES)
        share = event_share(*real_event_total(
            drn_per_event(pred, batch, cfg.drn.head), batch), mesh)
        return share, share

    return objective


def drn_dp_eval_terms(cfg: Config) -> Callable:
    """The DRN's ``(model, local batch) -> (v_met, loss total, real events,
    None)``, GraphMET's being ``train/step.eval_step_terms``."""

    def terms(model, batch: EventBatch):
        pred = drn_net_apply(model, batch, **DRN_MESH_FORCES)
        v_met = drn_met_vector(pred, cfg.drn.head)
        return (v_met, *real_event_total(
            drn_per_event(pred, batch, cfg.drn.head), batch), None)

    return terms


def make_dp_train_step(cfg: Config, mesh, family: str = DEFAULT
                       ) -> Callable:
    """The data-parallel train step ``(model, optimizer, local batch) ->
    global loss`` of ``family``: batch statistics and gradients over the
    mesh's data group."""
    return mesh_step(cfg, mesh, mesh_forms(family).dp_objective(cfg, mesh),
                     pctx.data_parallel, mesh.data_group)


def eval_padding(mesh) -> Callable[[EventBatch], EventBatch]:
    """A host batch padded with empty events to a multiple of the data
    axis."""
    def pad(batch: EventBatch) -> EventBatch:
        rem = batch.batch_size % mesh.n_data
        return (pad_batch_events(batch, batch.batch_size + mesh.n_data - rem)
                if rem else batch)

    return pad


def make_dp_eval_step(cfg: Config, mesh, family: str = DEFAULT
                      ) -> Callable:
    """``(model, padded global batch on the device) -> (v_met [B, 2], loss,
    weights [B, N] or None)``: each rank evaluates its rows of the batch
    (``eval_padding`` pads it to a multiple of D) in eval mode, in float32;
    the MET vectors and GraphMET's weights are gathered over the data
    group, and the loss, the mean over the batch's real events, sums the
    ranks' per-event totals and counts."""
    terms = mesh_forms(family).dp_eval_terms(cfg)

    @torch.no_grad()
    def eval_step(model, batch: EventBatch):
        model.eval()
        local = shard_batch(batch, mesh)
        with pctx.data_parallel(mesh):
            v_local, total, n, w = terms(model, local)
        v_met = gather_rows(v_local, mesh, mesh.data_group)
        if w is not None:
            w = gather_rows(w, mesh, mesh.data_group)
        total = mesh.all_reduce(total.clone(), mesh.data_group)
        n = mesh.all_reduce(n.clone(), mesh.data_group)
        return v_met, 0.5 * total / torch.clamp(n, min=1), w

    return eval_step


def make_sharded_eval(cfg: Config, mesh, family: str = DEFAULT
                      ) -> Tuple[Callable, Callable]:
    """(eval_step, eval_place) for mesh evaluation (the JAX package's
    ``train/loop.py:make_sharded_eval``): ``eval_place`` pads a host batch
    to a multiple of D and puts it on the rank's device; ``eval_step``
    takes such a batch.  Every batch shards over the mesh, odd sizes
    included."""
    pad = eval_padding(mesh)
    step = make_dp_eval_step(cfg, mesh, family)

    def eval_place(batch: EventBatch) -> EventBatch:
        return to_device(pad(EventBatch(*(np.asarray(f) for f in batch))),
                         mesh.device)

    return step, eval_place
