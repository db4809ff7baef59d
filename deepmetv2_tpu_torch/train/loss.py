"""The losses (the JAX package's ``train/loss.py``; reference
model/net.py:49-90).  The reference's ``scatter_add(w·p, batch)`` is a
masked sum over the node axis of the padded batch."""

from __future__ import annotations

from typing import Tuple

import torch

from deepmetv2_tpu_torch.data.batching import EventBatch


def weighted_met(weights: torch.Tensor, batch: EventBatch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-event ``Σ_i w_i·px_i`` and ``Σ_i w_i·py_i`` over real nodes (the
    MET estimate is the negative of this sum)."""
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    metx = torch.where(batch.mask, weights * batch.x_cont[..., 0], zero).sum(1)
    mety = torch.where(batch.mask, weights * batch.x_cont[..., 1], zero).sum(1)
    return metx, mety


def met_per_event(metx: torch.Tensor, mety: torch.Tensor,
                  batch: EventBatch) -> torch.Tensor:
    """(METx + genMETx)² + (METy + genMETy)² per event, from the sums of
    ``weighted_met``."""
    return (metx + batch.y[:, 0]) ** 2 + (mety + batch.y[:, 1]) ** 2


def real_event_total(per_event: torch.Tensor, batch: EventBatch
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ of ``per_event`` over real events, their count): events with
    ``num_valid == 0`` (batch padding) are left out."""
    ev = batch.num_valid > 0
    return (torch.where(ev, per_event, torch.zeros_like(per_event)).sum(),
            ev.sum())


def loss_fn(weights: torch.Tensor, batch: EventBatch) -> torch.Tensor:
    """0.5 · mean over real events of (METx + genMETx)² + (METy + genMETy)²;
    events with ``num_valid == 0`` (batch padding) are left out."""
    total, n = real_event_total(met_per_event(*weighted_met(weights, batch),
                                              batch), batch)
    return 0.5 * total / torch.clamp(n, min=1)


def drn_met_vector(pred: torch.Tensor, head: str = "polar") -> torch.Tensor:
    """DRN head output → cartesian MET ``[B, 2]``: 'cartesian' passes
    (METx, METy) through, 'polar' converts (MET, φ)."""
    if head == "cartesian":
        return pred[:, 0:2]
    met, phi = pred[:, 0], pred[:, 1]
    return torch.stack([met * torch.cos(phi), met * torch.sin(phi)], dim=1)


def drn_loss_fn(pred: torch.Tensor, batch: EventBatch,
                head: str = "polar") -> torch.Tensor:
    """0.5 · mean over real events of ‖v_pred − genMET‖² for the DRN head
    (events with ``num_valid == 0`` are left out)."""
    total, n = real_event_total(drn_per_event(pred, batch, head), batch)
    return 0.5 * total / torch.clamp(n, min=1)


def drn_per_event(pred: torch.Tensor, batch: EventBatch,
                  head: str = "polar") -> torch.Tensor:
    """‖v_pred − genMET‖² per event."""
    v = drn_met_vector(pred, head)
    return (v[:, 0] - batch.y[:, 0]) ** 2 + (v[:, 1] - batch.y[:, 1]) ** 2


def u_perp_par_loss(weights: torch.Tensor, batch: EventBatch) -> torch.Tensor:
    """The reference's recoil-decomposition loss (model/net.py:71-90),
    present there but unused by its training loop; kept for parity,
    including its use of ``y[:, 0]`` for BOTH components of qT."""
    qtx = batch.y[:, 0]
    qty = batch.y[:, 0]  # sic: the reference uses truth[:,0] twice
    v_qt = torch.stack([qtx, qty], dim=1)
    metx, mety = weighted_met(weights, batch)
    vec = torch.stack([-metx, -mety], dim=1)
    qt2 = (v_qt * v_qt).sum(1)
    response = (vec * v_qt).sum(1) / qt2
    v_par = response[:, None] * v_qt
    u_par = torch.sqrt((v_par * v_par).sum(1)) - torch.sqrt(qt2)
    v_perp = vec - v_par
    u_perp = torch.sqrt((v_perp * v_perp).sum(1))
    return 0.5 * torch.mean(u_par ** 2 + u_perp ** 2)
