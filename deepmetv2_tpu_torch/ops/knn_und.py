"""The fused undirected kNN graph build in plain PyTorch (the JAX package's
``ops/pallas/knn_und.py``).

The DRN's symmetrized feature-space kNN graph is a threshold relation.
With t_i the k-th smallest masked squared distance from node i (counted
with multiplicity),

    U(i, j) = (d²(i,j) <= t_i  or  d²(i,j) <= t_j)  and  valid_j  and  i != j

and each row lists its first ``cap`` members in ascending (d², index)
order, so rows past the cap keep their nearest ``cap`` neighbours.
ParticleNet's graph is the directed relation ``d²(i,j) <= t_i`` alone
(``directed=True``): with ``cap = k`` each real row lists its own k
nearest real sources.

This module is the CPU path and the oracle of the CUDA kernels
(ops/cuda/knn_und.py, csrc/knn_und.cu).  Both compute

    d²(i,j) = max((sq_i + sq_j) − 2·dot(i,j), 0)

with ``sq`` and ``dot`` summed over the feature axis in ascending order,
one rounded operation at a time (no fused multiply-add), so that d² is
symmetric bit for bit, t_i is one of the values the extraction compares
against it, and kernel and plain version agree bit for bit on the card.

Rows of padded queries (mask false) have defined outputs: ``t = +inf``,
every slot index 0 with d² +inf, and an all-false relation row.  Real rows
do not depend on padded nodes at all: leaving them out moves no bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood

TILE = 128     # the JAX kernels' row tile and lane width


def supported(n: int, cap: int) -> bool:
    """The shapes the JAX package's fused build takes (``knn_und.py:182``
    at its default tile); the port takes exactly those."""
    return n % TILE == 0 and n >= TILE and cap <= TILE


def sq_norms(h: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` squared norms, summed over h in ascending order."""
    sq = torch.zeros(h.shape[:2], dtype=torch.float32, device=h.device)
    for c in range(h.shape[-1]):
        sq = sq + h[..., c] * h[..., c]
    return sq


def event_d2(h: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """``[N, N]`` squared distances of one event (``h [N, H]``, ``sq
    [N]``): the dot product accumulated over h in ascending order, each
    product and sum rounded on its own."""
    N = h.shape[0]
    dot = torch.zeros((N, N), dtype=torch.float32, device=h.device)
    prod = torch.empty_like(dot)
    for c in range(h.shape[-1]):
        torch.mul(h[:, c, None], h[None, :, c], out=prod)
        dot.add_(prod)
    return torch.clamp((sq[:, None] + sq[None, :]) - 2.0 * dot, min=0.0)


def _valid(mask_b: torch.Tensor) -> torch.Tensor:
    """Sources that count for every query row: real, and not the query."""
    N = mask_b.shape[0]
    return mask_b[None, :] & ~torch.eye(N, dtype=torch.bool,
                                         device=mask_b.device)


def knn_kth_torch(h: torch.Tensor, mask: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(t, sq)``: ``t [B, N]`` per node the k-th smallest masked d² (self
    and padded sources are +inf), +inf where fewer than k sources are
    valid and on padded rows, and the squared norms ``sq [B, N]`` it was
    computed with (every row's), which the extraction takes."""
    h = h.detach().float()
    B, N, _ = h.shape
    if not 1 <= k <= N:
        raise ValueError(f"knn_kth: k={k} outside 1..N={N}")
    sq = sq_norms(h)
    t = torch.empty((B, N), dtype=torch.float32, device=h.device)
    inf = torch.tensor(float("inf"), device=h.device)
    for b in range(B):
        d2m = torch.where(_valid(mask[b]), event_d2(h[b], sq[b]), inf)
        t[b] = torch.where(mask[b], torch.kthvalue(d2m, k, dim=-1).values,
                           inf)
    return t, sq


def knn_extract_torch(h: torch.Tensor, mask: torch.Tensor, t: torch.Tensor,
                      sq: torch.Tensor, cap: int, want_rel: bool = False,
                      directed: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """The threshold relation's first ``cap`` members per row in ascending
    (d², index) order, from the thresholds and squared norms of
    ``knn_kth_torch``: ``idx [B, N, cap]`` int32 (0 where the row ran
    dry), ``d2v [B, N, cap]`` f32 (+inf where dry), and with ``want_rel``
    the relation ``rel [B, N, N]`` bool.  Padded query rows hold no member:
    their slots are all dry and their relation rows false.  ``directed``:
    the relation ``d² <= t_i`` alone."""
    h = h.detach().float()
    B, N, _ = h.shape
    idx = torch.empty((B, N, cap), dtype=torch.int32, device=h.device)
    d2v = torch.empty((B, N, cap), dtype=torch.float32, device=h.device)
    rel = (torch.empty((B, N, N), dtype=torch.bool, device=h.device)
           if want_rel else None)
    inf = torch.tensor(float("inf"), device=h.device)
    for b in range(B):
        d2 = event_d2(h[b], sq[b])
        near = d2 <= t[b][:, None]
        if not directed:
            near = near | (d2 <= t[b][None, :])
        u = near & _valid(mask[b]) & mask[b][:, None]
        vals, order = torch.sort(torch.where(u, d2, inf), dim=-1,
                                 stable=True)
        vals, order = vals[:, :cap], order[:, :cap]
        d2v[b] = vals
        idx[b] = torch.where(torch.isfinite(vals), order,
                             torch.zeros_like(order)).to(torch.int32)
        if want_rel:
            rel[b] = u
    return idx, d2v, rel


def neighborhood(idx: torch.Tensor, d2v: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[Neighborhood, torch.Tensor]:
    """The extraction's slots as a ``Neighborhood`` (slots of padded query
    rows and dry slots masked, their index 0) and the listed edges' d²
    (+inf at masked slots)."""
    nmask = torch.isfinite(d2v) & mask[..., None]
    nbr = Neighborhood(idx=torch.where(nmask, idx, torch.zeros_like(idx)),
                       mask=nmask)
    return nbr, torch.where(nmask, d2v, torch.full_like(d2v, float("inf")))
