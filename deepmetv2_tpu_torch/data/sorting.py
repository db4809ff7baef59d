"""Eta and cell sorting and halo sizing (the JAX package's
``data/sorting.py``).

After each event's candidates are sorted by eta (or put in cell order),
every radius-graph neighbour of a node lies within ``halo`` index
positions of it, so the EdgeConv aggregation becomes a masked window
reduction (ops/window.py).
The model and the loss are permutation-invariant per event; the
permutation is returned for consumers that need the caller's order.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def auto_block_rows(batch: EventBatch, r: float) -> int:
    """Block size for ``cell_sort_batch``: about the number of eta-sorted
    rows an r-wide eta slab spans, rounded up to a multiple of 32, at
    least 64."""
    eta = np.asarray(batch.x_cont[..., 3])
    mask = np.asarray(batch.mask)
    nv = mask.sum(axis=1)
    spans = []
    for b in range(eta.shape[0]):
        if nv[b] < 2:
            continue
        e = eta[b][mask[b]]
        spans.append(nv[b] * r / max(float(e.max() - e.min()), 1e-6))
    if not spans:
        return 64
    g = int(np.median(spans))
    return max(64, -(-g // 32) * 32)


def cell_sort_batch(batch: EventBatch, r: float = 0.4,
                    block_rows: Optional[int] = None) -> EventBatch:
    """Host cell order: eta-sort each event, then sort by phi inside fixed
    blocks of ``block_rows`` consecutive rows (eta-quantile cells), padding
    last.  The window path is order-agnostic given halo >=
    ``required_span_batch`` of the order; the cell order is the training
    CLI's default."""
    G = int(block_rows if block_rows is not None
            else auto_block_rows(batch, r))
    eta = np.asarray(batch.x_cont[..., 3])
    phi = np.arctan2(np.asarray(batch.x_cont[..., 1]),
                     np.asarray(batch.x_cont[..., 0]))
    mask = np.asarray(batch.mask)
    B, N = eta.shape
    p1 = np.argsort(np.where(mask, eta, np.inf), axis=1, kind="stable")
    phi_s = np.take_along_axis(np.where(mask, phi, np.inf), p1, axis=1)
    blk = np.broadcast_to(np.arange(N) // G, (B, N))
    p2 = np.lexsort((phi_s, blk), axis=1)
    perm = np.take_along_axis(p1, p2, axis=1)

    def take(arr):
        arr = np.asarray(arr)
        if arr.ndim == 3:
            return np.take_along_axis(arr, perm[..., None], axis=1)
        return np.take_along_axis(arr, perm, axis=1)

    return EventBatch(x_cont=take(batch.x_cont), x_cat=take(batch.x_cat),
                      mask=take(batch.mask), y=batch.y,
                      num_valid=batch.num_valid)


def required_span_arrays(eta, phi, mask, r: float) -> int:
    """Smallest halo H such that, in the CURRENT row order, every pair with
    ``(Δeta)² + (Δphi)² < r²`` is within H index positions (any order)."""
    eta, phi, mask = np.asarray(eta), np.asarray(phi), np.asarray(mask)
    r2 = float(r) ** 2
    worst = 0
    for b in range(eta.shape[0]):
        e = eta[b][mask[b]].astype(np.float64)
        p = phi[b][mask[b]].astype(np.float64)
        n = len(e)
        if n == 0:
            continue
        idx = np.arange(n)
        for s in range(0, n, 512):
            q = slice(s, min(s + 512, n))
            d2 = (e[q, None] - e[None, :]) ** 2 + (p[q, None] - p[None, :]) ** 2
            adj = d2 < r2                       # self is adjacent: d2 == 0
            jq = idx[q, None]
            j_hi = np.where(adj, idx[None, :], jq).max(axis=1)
            j_lo = np.where(adj, idx[None, :], jq).min(axis=1)
            worst = max(worst, int(np.max(j_hi - idx[q])),
                        int(np.max(idx[q] - j_lo)))
    return worst


def required_span_blocks(batch: EventBatch, r: float,
                         block_rows: Optional[int] = None) -> int:
    """Conservative halo bound for a cell-sorted batch: an in-radius pair
    can only join rows of blocks whose eta ranges come within r of each
    other, so the worst row distance is bounded by block-pair row extents.
    Ignores phi, hence an upper bound (adjacency is re-tested exactly)."""
    G = int(block_rows if block_rows is not None
            else auto_block_rows(batch, r))
    eta = np.asarray(batch.x_cont[..., 3])
    mask = np.asarray(batch.mask)
    B, N = eta.shape
    n_blk = -(-N // G)
    pad = n_blk * G - N
    elo = np.where(mask, eta, np.inf)      # empty blocks → (inf, -inf),
    ehi = np.where(mask, eta, -np.inf)     # excluded by the isfinite filter
    if pad:
        elo = np.pad(elo, ((0, 0), (0, pad)), constant_values=np.inf)
        ehi = np.pad(ehi, ((0, 0), (0, pad)), constant_values=-np.inf)
    emin = elo.reshape(B, n_blk, G).min(axis=-1)           # [B, n_blk]
    emax = ehi.reshape(B, n_blk, G).max(axis=-1)
    worst = 0
    for b in range(B):
        gs = np.where(np.isfinite(emin[b]))[0]
        for g in gs:
            for h in gs:
                if (emin[b, h] < emax[b, g] + r and
                        emax[b, h] > emin[b, g] - r):
                    span = max((h + 1) * G - 1 - g * G,
                               (g + 1) * G - 1 - h * G)
                    worst = max(worst, span)
    return int(worst)


def required_span_batch(batch: EventBatch, r: float) -> int:
    """``required_span_arrays`` over a collated batch's current order."""
    eta = np.asarray(batch.x_cont[..., 3])
    phi = np.arctan2(np.asarray(batch.x_cont[..., 1]),
                     np.asarray(batch.x_cont[..., 0]))
    return required_span_arrays(eta, phi, np.asarray(batch.mask), r)


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
