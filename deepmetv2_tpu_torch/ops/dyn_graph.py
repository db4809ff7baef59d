"""The DRN's per-round dynamic graph and its coarsening matching (the JAX
package's ``ops/dyn_graph.py``, fused strategy).

Each reduction round builds the symmetrized feature-space kNN graph of the
current features with the fused build (ops/cuda/knn_und.py: two kernels on
the card, their plain versions on the CPU) and matches on the post-conv
features with normalized-cut weights.  Up to ``DENSE_MATCH_MAX_N`` nodes
the matching runs on the extraction's own threshold relation (``rel``),
above it on a relation recomputed tile by tile, and past
``DENSE_W_MAX_ELEMS`` on the neighbour lists.

Only the fused strategy is ported: shapes the JAX fused build does not
take (N not a multiple of 128, cap above 128) raise rather than silently
taking the composed path, whose graph differs at hubs (ROADMAP C).
``want_mirror`` (``mirror_gather``) keeps only the listed edges whose
reverse edge is listed too, which makes the list symmetric, and carries
its mirror-slot table as the JAX package's graph does (the port's EdgeConv
backward sums x's gradient through a reverse index on every list).  The
``[B, N, N]`` products outside the kernels are ``torch.matmul`` in full
f32 (callers keep TF32 off).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops.coarsen import (handshake_matching,
                                             handshake_matching_dense,
                                             normalized_cut_weights)
from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph
from deepmetv2_tpu_torch.ops.knn_und import supported
from deepmetv2_tpu_torch.ops.segment import mirror_slots_sorted

# Up to this node count the extraction emits its relation rows and the
# dense matching consumes them.
DENSE_MATCH_MAX_N = 4096
# Above it the relation is recomputed in column tiles into one [B, N, N]
# weight matrix, up to this many elements; beyond, the list matching.
DENSE_W_MAX_ELEMS = 8 * 8192 * 8192


@dataclasses.dataclass(frozen=True)
class DynGraph:
    """One round's graph: the neighbour lists, each listed edge's d²
    ``[B, N, cap]``, the k-th-neighbour thresholds ``t [B, N]``, the
    features it was built from ``h0``, up to ``DENSE_MATCH_MAX_N`` the
    threshold relation ``rel [B, N, N]`` bool, and with ``want_mirror``
    the mirror-slot table ``mirror [B, N, cap]`` int32
    (ops/segment.py:mirror_slots_sorted)."""

    nbr: Neighborhood
    d2v: torch.Tensor
    t: torch.Tensor
    h0: torch.Tensor
    rel: Optional[torch.Tensor] = None
    mirror: Optional[torch.Tensor] = None


def build_dyn_graph(h: torch.Tensor, mask: torch.Tensor, k: int = 16,
                    cap: Optional[int] = None,
                    want_mirror: bool = False) -> DynGraph:
    """The symmetrized kNN graph of ``h`` (``to_undirected(knn_graph(h,
    mask, k))``, capped at ``cap``, default 2k) by the fused build.  Never
    differentiable.  ``want_mirror`` intersects the slot mask with the
    edges whose reverse is listed and adds the mirror table (JAX
    dyn_graph.py:144-148)."""
    cap = 2 * k if cap is None else cap
    if not supported(h.shape[1], cap):
        raise NotImplementedError(
            f"dynamic graph at N={h.shape[1]}, cap={cap}: not ported yet "
            "(composed path); the fused build takes N a multiple of 128 "
            "and cap <= 128")
    h = h.detach()
    if h.shape[1] <= DENSE_MATCH_MAX_N:
        nbr, d2v, t, rel = knn_und_graph(h, mask, k=k, cap=cap,
                                         want_rel=True)
    else:
        (nbr, d2v, t), rel = knn_und_graph(h, mask, k=k, cap=cap), None
    if want_mirror:
        mirror, found = mirror_slots_sorted(nbr)
        return DynGraph(nbr=Neighborhood(idx=nbr.idx, mask=found), d2v=d2v,
                        t=t, h0=h, rel=rel, mirror=mirror)
    return DynGraph(nbr=nbr, d2v=d2v, t=t, h0=h, rel=rel)


def _pairwise_d2(h: torch.Tensor) -> torch.Tensor:
    """``[B, N, N]`` squared distances |a|² + |b|² − 2a·b."""
    sq = (h * h).sum(dim=-1)
    dot = torch.matmul(h, h.transpose(1, 2))
    return torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dot, min=0.0)


def _tiled_cut_weights(h0: torch.Tensor, t: torch.Tensor, h: torch.Tensor,
                       mask: torch.Tensor, tile_c: int = 2048
                       ) -> torch.Tensor:
    """The ``[B, N, N]`` normalized-cut weight matrix of the threshold
    relation U = d²(h0) <= t_i or <= t_j, built in ``[B, N, tile_c]``
    column tiles: degrees from a first U-only sweep, then the weights
    dist(h)·(1/deg_i + 1/deg_j) on U, −inf elsewhere."""
    B, N = mask.shape
    iota = torch.arange(N, device=h.device)
    sq0 = (h0 * h0).sum(dim=-1)
    sqp = (h * h).sum(dim=-1)

    def tile_u(c0):
        c1 = c0 + tile_c
        dot = torch.matmul(h0, h0[:, c0:c1].transpose(1, 2))
        d2 = torch.clamp(sq0[:, :, None] + sq0[:, None, c0:c1] - 2.0 * dot,
                         min=0.0)
        v = (mask[:, :, None] & mask[:, None, c0:c1]
             & (iota[:, None] != iota[None, c0:c1]))
        return ((d2 <= t[:, :, None]) | (d2 <= t[:, None, c0:c1])) & v

    starts = range(0, N, tile_c)
    deg = sum(tile_u(c0).sum(dim=-1) for c0 in starts).to(h.dtype)
    ivd = 1.0 / torch.clamp(deg, min=1.0)
    parts = []
    for c0 in starts:
        c1 = c0 + tile_c
        dot = torch.matmul(h, h[:, c0:c1].transpose(1, 2))
        dist = torch.sqrt(torch.clamp(
            sqp[:, :, None] + sqp[:, None, c0:c1] - 2.0 * dot, min=0.0))
        w = dist * (ivd[:, :, None] + ivd[:, None, c0:c1])
        parts.append(torch.where(tile_u(c0), w, torch.full_like(w, -torch.inf)))
    return torch.cat(parts, dim=2)


def cut_matching(g: DynGraph, h: torch.Tensor, mask: torch.Tensor,
                 rounds: int = 4):
    """Normalized-cut-weighted handshake matching on ``g`` with the
    post-conv features ``h``: ``(cluster, partner)``.  Discrete, no
    gradient."""
    h = h.detach()
    B, N = mask.shape
    if N <= DENSE_MATCH_MAX_N:
        if g.rel is None:
            raise ValueError("cut_matching: the graph carries no relation")
        U = g.rel
        ivd = 1.0 / torch.clamp(U.sum(dim=-1).to(h.dtype), min=1.0)
        dist = torch.sqrt(_pairwise_d2(h))
        W = torch.where(U, dist * (ivd[:, :, None] + ivd[:, None, :]),
                        torch.full_like(dist, -torch.inf))
        return handshake_matching_dense(W, mask, rounds=rounds)
    if B * N * N <= DENSE_W_MAX_ELEMS:
        tile_c = next((c for c in range(min(2048, N), 127, -128)
                       if N % c == 0 and c % 128 == 0), None)
        if tile_c is not None:
            W = _tiled_cut_weights(g.h0, g.t, h, mask, tile_c)
            return handshake_matching_dense(W, mask, rounds=rounds)
    w = normalized_cut_weights(h, g.nbr)
    return handshake_matching(w, g.nbr, mask, rounds=rounds)
