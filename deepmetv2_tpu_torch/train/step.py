"""Per-batch steps (the JAX package's ``train/step.py``): graph building and
the evaluation step.  The training step comes with the training slice."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from deepmetv2_tpu_torch.config import Config
from deepmetv2_tpu_torch.data.batching import EventBatch
from deepmetv2_tpu_torch.data.sorting import sort_by_eta
from deepmetv2_tpu_torch.models.graph_met import GraphMET, net_apply
from deepmetv2_tpu_torch.ops.window import WindowGraph
from deepmetv2_tpu_torch.train.loss import loss_fn


def window_graph(batch: EventBatch, cfg: Config) -> WindowGraph:
    """The implicit radius graph of a batch in its current (eta-sorted)
    order, over (eta, phi = atan2(py, px))."""
    if cfg.graph.mode != "window":
        raise NotImplementedError(
            f"graph mode {cfg.graph.mode!r} is not ported yet; use 'window'")
    phi = torch.atan2(batch.x_cont[..., 1], batch.x_cont[..., 0])
    etaphi = torch.stack([batch.x_cont[..., 3], phi], dim=-1)
    return WindowGraph(etaphi, batch.mask, r=cfg.graph.delta_r,
                       halo=cfg.graph.window_halo)


def build_graph(batch: EventBatch, cfg: Config
                ) -> Tuple[EventBatch, WindowGraph]:
    """Window mode (reference train.py:44-48): the batch comes back
    eta-sorted (unless ``cfg.graph.presorted``) with its graph."""
    if not cfg.graph.presorted:
        batch, _ = sort_by_eta(batch)
    return batch, window_graph(batch, cfg)


def eval_step_body(cfg: Config) -> Callable:
    """``(model, batch) -> (weights, loss)`` with the weights in the
    CALLER's candidate order: the forward runs on the eta-sorted batch and
    the weights come back through the inverse permutation."""

    def eval_step(model: GraphMET, batch: EventBatch):
        batch_s, perm = sort_by_eta(batch)   # a no-op order if presorted
        w = net_apply(model, batch_s, window_graph(batch_s, cfg))
        loss = loss_fn(w, batch_s)
        return torch.gather(w, 1, torch.argsort(perm, dim=1)), loss

    return eval_step


def make_eval_step(cfg: Config) -> Callable:
    """The evaluation step under ``torch.no_grad()`` with the model in eval
    mode (running BatchNorm statistics)."""
    body = eval_step_body(cfg)

    @torch.no_grad()
    def eval_step(model: GraphMET, batch: EventBatch):
        model.eval()
        return body(model, batch)

    return eval_step
