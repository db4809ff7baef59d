"""Eta sorting and halo sizing (the JAX package's ``data/sorting.py``).

After each event's candidates are sorted by eta, every radius-graph
neighbour of a node lies within ``halo`` index positions of it, so the
EdgeConv aggregation becomes a masked window reduction (ops/window.py).
The model and the loss are permutation-invariant per event; the
permutation is returned for consumers that need the caller's order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.data.batching import EventBatch


def sort_by_eta(batch: EventBatch) -> Tuple[EventBatch, torch.Tensor]:
    """Stable sort of each event's candidates by eta, padding (key +inf)
    last.  Returns ``(sorted_batch, perm)``, ``perm[b, i]`` = original index
    of the candidate now at slot i."""
    key = torch.where(batch.mask, batch.x_cont[..., 3],
                      torch.full_like(batch.x_cont[..., 3], float("inf")))
    perm = torch.argsort(key, dim=1, stable=True)

    def take(arr):
        if arr.ndim == 3:
            return torch.gather(arr, 1, perm[..., None].expand(-1, -1, arr.shape[2]))
        return torch.gather(arr, 1, perm)

    out = EventBatch(x_cont=take(batch.x_cont), x_cat=take(batch.x_cat),
                     mask=take(batch.mask), y=batch.y,
                     num_valid=batch.num_valid)
    return out, perm


def presort_batch(batch: EventBatch) -> EventBatch:
    """Host (numpy) equivalent of ``sort_by_eta`` for a collated batch."""
    eta = np.asarray(batch.x_cont[..., 3])
    mask = np.asarray(batch.mask)
    perm = np.argsort(np.where(mask, eta, np.inf), axis=1, kind="stable")

    def take(arr):
        arr = np.asarray(arr)
        if arr.ndim == 3:
            return np.take_along_axis(arr, perm[..., None], axis=1)
        return np.take_along_axis(arr, perm, axis=1)

    return EventBatch(x_cont=take(batch.x_cont), x_cat=take(batch.x_cat),
                      mask=take(batch.mask), y=batch.y,
                      num_valid=batch.num_valid)


def required_halo_arrays(eta, mask, r: float) -> int:
    """Smallest halo H such that, in eta-sorted order, every pair with
    |Δeta| < r is within H index positions.  ``eta``/``mask``: [B, N]."""
    eta = np.asarray(eta)
    mask = np.asarray(mask)
    worst = 0
    for b in range(eta.shape[0]):
        e = np.sort(eta[b][mask[b]].astype(np.float64))
        if len(e) == 0:
            continue
        lo = np.searchsorted(e, e - r, side="left")
        hi = np.searchsorted(e, e + r, side="right")
        idx = np.arange(len(e))
        worst = max(worst, int(np.max(idx - lo)), int(np.max(hi - 1 - idx)))
    return worst


def required_halo_events(events, r: float) -> int:
    """``required_halo`` over raw ``(x, y)`` events (eta at column 3)."""
    worst = 0
    for x, _ in events:
        e = np.asarray(x[:, 3])[None, :]
        worst = max(worst, required_halo_arrays(
            e, np.ones_like(e, dtype=bool), r))
    return worst


def required_halo(batch: EventBatch, r: float) -> int:
    """Smallest halo for a collated host EventBatch."""
    return required_halo_arrays(np.asarray(batch.x_cont[..., 3]),
                                np.asarray(batch.mask), r)
