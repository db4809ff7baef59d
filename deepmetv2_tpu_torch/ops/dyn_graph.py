"""The DRN's per-round dynamic graph and its coarsening matching (the JAX
package's ``ops/dyn_graph.py``, fused strategy).

Each reduction round builds the symmetrized feature-space kNN graph of the
current features with the fused build (ops/cuda/knn_und.py: two kernels on
the card, their plain versions on the CPU) and matches on the post-conv
features with normalized-cut weights.  Up to ``DENSE_W_MAX_ELEMS`` elements
of ``[B, N, N]`` the matching runs on the extraction's own threshold
relation (``rel``), its weights built whole up to ``DENSE_MATCH_MAX_N``
nodes and above it in column tiles; past that on the neighbour lists.  The
relation is never recomputed: each row's k-th neighbour lies exactly at
its threshold in the kernels' d² arithmetic, so any other summation order
drops or adds pairs.

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

# Up to this node count the dense matching builds its weights at once.
DENSE_MATCH_MAX_N = 4096
# Above it the weights are built from the relation in column tiles of
# DENSE_TILE_C into one [B, N, N] matrix, up to DENSE_W_MAX_ELEMS elements;
# beyond, the list matching, and the extraction emits no relation.
DENSE_TILE_C = 2048
DENSE_W_MAX_ELEMS = 8 * 8192 * 8192


def dense_matching(B: int, N: int) -> bool:
    """Whether the matching of a ``[B, N]`` round runs on the relation (the
    dense matching), which the graph build then has to emit."""
    return N <= DENSE_MATCH_MAX_N or B * N * N <= DENSE_W_MAX_ELEMS


@dataclasses.dataclass(frozen=True)
class DynGraph:
    """One round's graph: the neighbour lists, each listed edge's d²
    ``[B, N, cap]``, the k-th-neighbour thresholds ``t [B, N]``, where the
    dense matching runs (``dense_matching``) the threshold relation ``rel
    [B, N, N]`` bool, and with ``want_mirror`` the mirror-slot table
    ``mirror [B, N, cap]`` int32 (ops/segment.py:mirror_slots_sorted)."""

    nbr: Neighborhood
    d2v: torch.Tensor
    t: torch.Tensor
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
    if dense_matching(*mask.shape):
        nbr, d2v, t, rel = knn_und_graph(h, mask, k=k, cap=cap,
                                         want_rel=True)
    else:
        (nbr, d2v, t), rel = knn_und_graph(h, mask, k=k, cap=cap), None
    if want_mirror:
        mirror, found = mirror_slots_sorted(nbr)
        return DynGraph(nbr=Neighborhood(idx=nbr.idx, mask=found), d2v=d2v,
                        t=t, rel=rel, mirror=mirror)
    return DynGraph(nbr=nbr, d2v=d2v, t=t, rel=rel)


def _tiled_cut_weights(rel: torch.Tensor, h: torch.Tensor,
                       tile_c: int = DENSE_TILE_C) -> torch.Tensor:
    """The ``[B, N, N]`` normalized-cut weight matrix of the extraction's
    threshold relation ``rel`` (bool), built in ``[B, N, tile_c]`` column
    tiles (one, not copied, when ``tile_c >= N``): the weights
    dist(h)·(1/deg_i + 1/deg_j) on the relation, −inf elsewhere, with the
    degrees counted from ``rel`` (whose padded rows and columns are zero;
    the matching masks padded rows itself)."""
    sqp = (h * h).sum(dim=-1)
    ivd = 1.0 / torch.clamp(rel.sum(dim=-1).to(h.dtype), min=1.0)
    parts = []
    for c0 in range(0, h.shape[1], tile_c):
        c1 = c0 + tile_c
        dot = torch.matmul(h, h[:, c0:c1].transpose(1, 2))
        dist = torch.sqrt(torch.clamp(
            sqp[:, :, None] + sqp[:, None, c0:c1] - 2.0 * dot, min=0.0))
        w = dist * (ivd[:, :, None] + ivd[:, None, c0:c1])
        parts.append(torch.where(rel[:, :, c0:c1], w,
                                 torch.full_like(w, -torch.inf)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def cut_matching(g: DynGraph, h: torch.Tensor, mask: torch.Tensor,
                 rounds: int = 4):
    """Normalized-cut-weighted handshake matching on ``g`` with the
    post-conv features ``h``: ``(cluster, partner)``.  Discrete, no
    gradient."""
    h = h.detach()
    B, N = mask.shape
    if dense_matching(B, N):
        if g.rel is None:
            raise ValueError("cut_matching: the graph carries no relation")
        tile_c = N if N <= DENSE_MATCH_MAX_N else DENSE_TILE_C
        W = _tiled_cut_weights(g.rel, h, tile_c)
        return handshake_matching_dense(W, mask, rounds=rounds)
    w = normalized_cut_weights(h, g.nbr)
    return handshake_matching(w, g.nbr, mask, rounds=rounds)
