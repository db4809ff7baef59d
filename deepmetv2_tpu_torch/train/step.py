"""Per-batch steps (the JAX package's ``train/step.py``): the optimizer,
graph building, and the train, BatchNorm refresh and evaluation steps of
GraphMET and of the DRN.

Where the JAX package carries a ``TrainState`` pytree through jitted steps,
the port keeps the model (parameters and BatchNorm buffers) and a
``torch.optim.AdamW`` and updates them in place; a train step returns the
loss as a device tensor without a host sync, so that a chain of steps can
be captured as one CUDA graph (train/chain.py).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple

import torch

from deepmetv2_tpu_torch.config import Config
from deepmetv2_tpu_torch.data.batching import EventBatch, Neighborhood
from deepmetv2_tpu_torch.data.sorting import sort_by_eta
from deepmetv2_tpu_torch.models.drn import drn_net_apply
from deepmetv2_tpu_torch.models.graph_met import GraphMET, net_apply
from deepmetv2_tpu_torch.ops.graph import radius_graph
from deepmetv2_tpu_torch.ops.window import WindowGraph
from deepmetv2_tpu_torch.train.loss import (drn_loss_fn, drn_met_vector,
                                            loss_fn)
from deepmetv2_tpu_torch.train.metrics import _neg_weighted_met


def make_optimizer(cfg: Config, model: torch.nn.Module,
                   capturable: Optional[bool] = None) -> torch.optim.AdamW:
    """AdamW as the reference configures it (train.py:75: lr 1e-3; torch's
    defaults betas (0.9, 0.999), eps 1e-8, weight decay 0.01), over every
    parameter of either model family (the DRN's ``datanorm`` included), as
    optax's ``adamw`` in the JAX package.  The optional global-norm clip is
    ``clip_by_global_norm`` in the train steps.

    ``capturable`` (default: the parameters lie on a CUDA device) builds
    the form a CUDA graph can hold (train/chain.py): ``capturable=True``,
    the step counts on the parameters' device, and the lr a 0-dim float32
    tensor there, which ``set_learning_rate`` writes in place.  Eager steps
    on the card use the same form, so they do the same arithmetic as
    replayed ones."""
    o = cfg.optim
    params = list(model.parameters())
    if capturable is None:
        capturable = params[0].device.type == "cuda"
    lr = (torch.tensor(o.lr, dtype=torch.float32, device=params[0].device)
          if capturable else o.lr)
    return torch.optim.AdamW(params, lr=lr, betas=tuple(o.betas), eps=o.eps,
                             weight_decay=o.weight_decay,
                             capturable=capturable)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the plateau-controlled lr into every parameter group: in place
    where the lr is a tensor (a captured graph reads that tensor), else as
    a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor],
                        max_norm: float) -> None:
    """optax's ``clip_by_global_norm``: with ``norm`` the l2 norm of all
    gradients, each gradient ``t`` becomes ``t / norm * max_norm`` when
    ``norm >= max_norm`` and stays as it is otherwise.  (torch's
    ``clip_grad_norm_`` divides by ``norm + 1e-6`` and rounds otherwise.)
    No host sync: the choice is a ``torch.where`` on the device."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _etaphi(batch: EventBatch) -> torch.Tensor:
    """``[B, N, 2]`` (eta, phi = atan2(py, px)) of a batch."""
    phi = torch.atan2(batch.x_cont[..., 1], batch.x_cont[..., 0])
    return torch.stack([batch.x_cont[..., 3], phi], dim=-1)


def window_graph(batch: EventBatch, cfg: Config) -> WindowGraph:
    """The implicit radius graph of a batch in its current order, over
    (eta, phi)."""
    if cfg.graph.mode != "window":
        raise ValueError(f"window_graph in graph mode {cfg.graph.mode!r}")
    return WindowGraph(_etaphi(batch), batch.mask, r=cfg.graph.delta_r,
                       halo=cfg.graph.window_halo)


def build_graph(batch: EventBatch, cfg: Config
                ) -> Tuple[EventBatch, "WindowGraph | Neighborhood"]:
    """The batch's graph in (eta, phi) (reference train.py:44-48).  Window
    mode: the batch comes back eta-sorted (unless ``cfg.graph.presorted``)
    with its implicit graph.  neighbor_list mode: the batch comes back as
    it is, with the radius graph's lists, capped at the nearest
    ``max_neighbors`` (self-loops with ``self_loops``, phi wrapped with
    ``phi_wraparound``)."""
    g = cfg.graph
    if g.mode != "window":
        wrap = (0.0, 2 * math.pi) if g.phi_wraparound else None
        return batch, radius_graph(_etaphi(batch), batch.mask, r=g.delta_r,
                                   k=g.max_neighbors, loop=g.self_loops,
                                   wrap_axes=wrap)
    if not g.presorted:
        batch, _ = sort_by_eta(batch)
    return batch, window_graph(batch, cfg)


def _step(cfg: Config, objective: Callable) -> Callable:
    """``(model, optimizer, batch) -> loss`` around ``objective(model,
    batch) -> loss``: forward in training mode (batch statistics; the
    BatchNorm buffers update), backward, optional global-norm clip, AdamW
    step.  The loss is the one before the update, a detached device
    scalar."""
    clip = cfg.optim.grad_clip_norm

    def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   batch: EventBatch) -> torch.Tensor:
        model.train()
        # gradients start from None: under capture, backward allocates them
        # in the graph's own memory, so every replayed step starts from zero
        optimizer.zero_grad(set_to_none=True)
        loss = objective(model, batch)
        loss.backward()
        if clip is not None:
            clip_by_global_norm(model.parameters(), clip)
        optimizer.step()
        return loss.detach()

    return train_step


def graphmet_objective(cfg: Config) -> Callable:
    """GraphMET's ``(model, batch) -> loss``: ``build_graph`` (in window
    mode it sorts unless presorted), ``loss_fn`` on the weights."""

    def objective(model: GraphMET, batch: EventBatch) -> torch.Tensor:
        batch, graph = build_graph(batch, cfg)
        return loss_fn(net_apply(model, batch, graph), batch)

    return objective


def drn_objective(cfg: Config) -> Callable:
    """The DRN's ``(model, batch) -> loss`` (JAX step.py:198-227): no
    radius graph, the model builds its kNN graphs per round;
    ``drn_loss_fn`` under ``cfg.drn.head``."""

    def objective(model, batch: EventBatch) -> torch.Tensor:
        return drn_loss_fn(drn_net_apply(model, batch), batch, cfg.drn.head)

    return objective


def make_train_step(cfg: Config, objective: Optional[Callable] = None
                    ) -> Callable:
    """The train step of ``_step`` on ``objective`` (default GraphMET's)."""
    return _step(cfg, objective or graphmet_objective(cfg))


def make_drn_train_step(cfg: Config) -> Callable:
    """The DRN's train step: ``make_train_step`` on ``drn_objective``."""
    return make_train_step(cfg, drn_objective(cfg))


def make_bn_refresh_step(objective: Callable) -> Callable:
    """One "precise-BN" pass ``(model, batch) -> None`` of the family
    whose ``objective`` it is given: the objective's forward with batch
    statistics under ``torch.no_grad()``, which updates only the BatchNorm
    running buffers (used by ``fit`` when ``cfg.train.bn_refresh_batches >
    0``)."""
    @torch.no_grad()
    def refresh(model, batch: EventBatch) -> None:
        model.train()
        objective(model, batch)

    return refresh


def eval_step_body(cfg: Config) -> Callable:
    """``(model, batch) -> (v_met [B, 2], loss, weights)`` with the
    weights in the CALLER's candidate order and ``v_met = −Σ wᵢpᵢ``.  In
    window mode, unless the batch is presorted, the forward runs on the
    eta-sorted batch and the weights come back through the inverse
    permutation; a presorted batch, and every batch in neighbor_list mode,
    runs in its own order."""

    def eval_step(model: GraphMET, batch: EventBatch):
        if cfg.graph.mode != "window" or cfg.graph.presorted:
            batch, graph = build_graph(batch, cfg)
            w = net_apply(model, batch, graph)
            return _neg_weighted_met(w, batch), loss_fn(w, batch), w
        batch_s, perm = sort_by_eta(batch)
        w = net_apply(model, batch_s, window_graph(batch_s, cfg))
        loss = loss_fn(w, batch_s)
        w = torch.gather(w, 1, torch.argsort(perm, dim=1))
        return _neg_weighted_met(w, batch), loss, w

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


def make_drn_eval_step(cfg: Config) -> Callable:
    """The DRN's evaluation step ``(model, batch) -> (v_met [B, 2], loss,
    None)`` under ``torch.no_grad()`` with the model in eval mode: the
    cartesian MET estimate, ``drn_loss_fn`` and no per-candidate weights,
    in the slots of GraphMET's step."""
    @torch.no_grad()
    def eval_step(model, batch: EventBatch):
        model.eval()
        pred = drn_net_apply(model, batch)
        return (drn_met_vector(pred, cfg.drn.head),
                drn_loss_fn(pred, batch, cfg.drn.head), None)

    return eval_step
