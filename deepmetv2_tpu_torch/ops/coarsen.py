"""Graph coarsening for the DRN (the JAX package's ``ops/coarsen.py``):
normalized-cut edge weights, deterministic handshake matching in its list
and dense forms, cluster-max pooling and the per-event max pool.

Handshake matching replaces graclus's sequential greedy matching: a fixed
number of rounds in which every unmatched node proposes to its heaviest
unmatched neighbour and mutual proposals match.  Every argmax takes the
lowest index among equal maxima, as ``jnp.argmax`` does (``torch.argmax``
documents the first occurrence too).  Pooling keeps the padded capacity:
a matched pair's representative (the lower index) takes the elementwise
max of both rows and the other row leaves the mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops.segment import batched_take, gather_neighbors

NEG_INF = float("-inf")


def _iota(B: int, N: int, device) -> torch.Tensor:
    return torch.arange(N, dtype=torch.int64, device=device).expand(B, N)


def normalized_cut_weights(pos: torch.Tensor, nbr: Neighborhood
                           ) -> torch.Tensor:
    """``w_ij = ‖x_i − x_j‖₂·(1/deg_i + 1/deg_j)`` per listed edge
    ``[B, N, K]``, −inf at invalid slots."""
    xj = gather_neighbors(pos, nbr)
    d = torch.sqrt(((pos[:, :, None, :] - xj) ** 2).sum(dim=-1))
    deg = nbr.mask.sum(dim=-1).to(pos.dtype)
    inv_deg = 1.0 / torch.clamp(deg, min=1.0)
    w = d * (inv_deg[:, :, None] + batched_take(inv_deg, nbr.idx))
    return torch.where(nbr.mask, w, torch.full_like(w, NEG_INF))


def _first_argmax(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, index of its first occurrence) along the last axis."""
    return w.amax(dim=-1), torch.argmax(w, dim=-1)


def handshake_matching(weights: torch.Tensor, nbr: Neighborhood,
                       node_mask: torch.Tensor, rounds: int = 4
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heavy-edge matching on neighbour lists: ``(cluster, partner)``, both
    ``[B, N]`` int64; a matched pair shares cluster ``min(i, partner)``,
    unmatched nodes and padding are their own cluster and partner."""
    B, N, _ = weights.shape
    iota = _iota(B, N, weights.device)
    idx = nbr.idx.to(torch.int64)
    matched = ~node_mask
    partner = iota
    for _ in range(rounds):
        tgt_matched = batched_take(matched, idx)
        ok = nbr.mask & ~tgt_matched & ~matched[:, :, None]
        w = torch.where(ok, weights, torch.full_like(weights, NEG_INF))
        best_w, best_k = _first_argmax(w)
        has = best_w > NEG_INF
        prop = torch.where(
            has, torch.gather(idx, 2, best_k[..., None])[..., 0], iota)
        mutual = ((torch.gather(prop, 1, prop) == iota) & (prop != iota)
                  & has & ~matched)
        partner = torch.where(mutual, prop, partner)
        matched = matched | mutual
    partner = torch.where(node_mask, partner, iota)
    return torch.minimum(iota, partner), partner


def handshake_matching_dense(W: torch.Tensor, node_mask: torch.Tensor,
                             rounds: int = 4
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``handshake_matching`` on a dense ``[B, N, N]`` weight matrix (−inf
    at non-edges and self): the same algorithm and tie rule, with the
    candidate masking elementwise."""
    B, N, _ = W.shape
    iota = _iota(B, N, W.device)
    ninf = torch.full_like(W, NEG_INF)
    W = torch.where(node_mask[:, :, None] & node_mask[:, None, :], W, ninf)
    matched = ~node_mask
    partner = iota
    for _ in range(rounds):
        blocked = matched[:, :, None] | matched[:, None, :]
        best_w, best = _first_argmax(torch.where(blocked, ninf, W))
        prop = torch.where(best_w > NEG_INF, best, iota)
        mutual = (torch.gather(prop, 1, prop) == iota) & (prop != iota)
        partner = torch.where(mutual, prop, partner)
        matched = matched | mutual
    partner = torch.where(node_mask, partner, iota)
    return torch.minimum(iota, partner), partner


def max_pool(x: torch.Tensor, cluster: torch.Tensor, partner: torch.Tensor,
             node_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster-max pooling: ``(pooled [B, N, H], new mask)``; each
    representative holds the max of its row and its partner's, every other
    row is 0 and leaves the mask."""
    iota = torch.arange(x.shape[1], device=x.device)[None, :]
    is_rep = (cluster == iota) & node_mask
    pooled = torch.maximum(x, batched_take(x, partner))
    return torch.where(is_rep[..., None], pooled, torch.zeros_like(x)), is_rep


def global_max_pool(x: torch.Tensor, node_mask: torch.Tensor
                    ) -> torch.Tensor:
    """Per-event max over valid nodes ``[B, H]``; 0 for an empty event."""
    masked = torch.where(node_mask[..., None], x, torch.full_like(x, NEG_INF))
    out = masked.amax(dim=1)
    return torch.where(node_mask.any(dim=1)[..., None], out,
                       torch.zeros_like(out))
