"""The DRN's per-round dynamic graph and its coarsening matching (the JAX
package's ``ops/dyn_graph.py``).

Each reduction round builds the symmetrized feature-space kNN graph of the
current features and matches on the post-conv features with normalized-cut
weights.  Two builds, as in the JAX package:

* fused: ops/cuda/knn_und.py (two kernels on the card, their plain
  versions on the CPU), for N a multiple of 128 and a cap of at most 128.
  Up to ``DENSE_W_MAX_ELEMS`` elements of ``[B, N, N]`` the matching runs
  on the extraction's own threshold relation (``rel``), its weights built
  whole up to ``DENSE_MATCH_MAX_N`` nodes and above it in column tiles;
  past that on the neighbour lists.  The relation is never recomputed:
  each row's k-th neighbour lies exactly at its threshold in the kernels'
  d² arithmetic, so any other summation order drops or adds pairs.
* composed: ``to_undirected(knn_graph(h, mask, k), cap)`` (ops/graph.py)
  in plain PyTorch, for every other shape.  Its graph differs from the
  fused one at hubs (the fused build keeps each row's nearest ``cap``
  members, the composed one drops the highest-indexed mutually).  Up to
  ``DENSE_MATCH_MAX_N`` nodes the matching's adjacency is scattered from
  the lists and its weights are the pairwise ones; above, the list
  matching.

The list matching (``list_matching``) runs as ops/cuda/cut_match.py's
kernels on the card and as their plain version on the CPU.

``want_mirror`` (``mirror_gather``) adds the lists' mirror-slot table; on
the fused build it also keeps only the listed edges whose reverse edge is
listed, which makes the list symmetric (the composed list is symmetric by
construction).  The ``[B, N, N]`` products are ``torch.matmul`` in full
f32 (callers keep TF32 off).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops.coarsen import handshake_matching_dense
from deepmetv2_tpu_torch.ops.cuda import cut_match as list_kernels
from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph
from deepmetv2_tpu_torch.ops.graph import knn_graph, to_undirected
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
    """One round's graph: the neighbour lists; from the fused build each
    listed edge's d² ``[B, N, cap]``, the k-th-neighbour thresholds ``t
    [B, N]`` and, where the dense matching runs (``dense_matching``), the
    threshold relation ``rel [B, N, N]`` bool (None from the composed
    build); with ``want_mirror`` the mirror-slot table ``mirror [B, N,
    cap]`` int32 (ops/segment.py:mirror_slots_sorted)."""

    nbr: Neighborhood
    d2v: Optional[torch.Tensor] = None
    t: Optional[torch.Tensor] = None
    rel: Optional[torch.Tensor] = None
    mirror: Optional[torch.Tensor] = None


def build_dyn_graph(h: torch.Tensor, mask: torch.Tensor, k: int = 16,
                    cap: Optional[int] = None, want_mirror: bool = False,
                    force: Optional[str] = None) -> DynGraph:
    """The symmetrized kNN graph of ``h`` (``to_undirected(knn_graph(h,
    mask, k))``, capped at ``cap``, default 2k).  ``force``: None takes the
    fused build where it applies (``supported``), the composed one
    elsewhere; 'fused' or 'composed' pins one.  Never differentiable.
    ``want_mirror`` adds the mirror table; on the fused build it also
    intersects the slot mask with the edges whose reverse is listed (JAX
    dyn_graph.py:144-148)."""
    if force not in (None, "fused", "composed"):
        raise ValueError(f"force={force!r}: None, 'fused' or 'composed'")
    cap = 2 * k if cap is None else cap
    h = h.detach()
    if force == "composed" or (force is None
                               and not supported(h.shape[1], cap)):
        nbr = to_undirected(knn_graph(h, mask, k=k, loop=False), cap=cap)
        mirror = mirror_slots_sorted(nbr)[0] if want_mirror else None
        return DynGraph(nbr=nbr, mirror=mirror)
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


def _list_relation(nbr: Neighborhood) -> torch.Tensor:
    """``[B, N, N]`` bool: True where j is a valid slot of i's list."""
    B, N, _ = nbr.idx.shape
    U = torch.zeros((B, N, N + 1), dtype=torch.bool, device=nbr.idx.device)
    cols = torch.where(nbr.mask, nbr.idx, torch.full_like(nbr.idx, N))
    U.scatter_(2, cols.long(), True)
    return U[:, :, :N]


def _tiled_cut_weights(rel: torch.Tensor, h: torch.Tensor,
                       tile_c: int = DENSE_TILE_C) -> torch.Tensor:
    """The ``[B, N, N]`` normalized-cut weight matrix of a relation ``rel``
    (bool: the extraction's threshold relation, or a composed graph's
    lists as ``_list_relation`` gives them), built in ``[B, N, tile_c]``
    column tiles (one, not copied, when ``tile_c >= N``): the weights
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


def list_matching(h: torch.Tensor, nbr: Neighborhood, mask: torch.Tensor,
                  rounds: int = 4):
    """The handshake matching on the neighbour lists ``nbr`` with their
    normalized-cut weights from ``h``: ``(cluster, partner)``, by
    ops/cuda/cut_match.py (the kernels on the card, their plain
    composition on the CPU)."""
    return list_kernels.cut_match(h, nbr, mask, rounds=rounds)


def cut_matching(g: DynGraph, h: torch.Tensor, mask: torch.Tensor,
                 rounds: int = 4):
    """Normalized-cut-weighted handshake matching on ``g`` with the
    post-conv features ``h``: ``(cluster, partner)``.  Discrete, no
    gradient.  The fused graph's dense matching reads its relation (the
    build emits one wherever ``dense_matching`` holds); the composed
    graph's, up to ``DENSE_MATCH_MAX_N`` nodes, the relation of its lists
    (JAX dyn_graph.py:238-262: the degree is the list's, which equals the
    relation's row count since a list is distinct, and the distances the
    pairwise |a|² + |b|² − 2a·b); otherwise the lists
    (``list_matching``)."""
    h = h.detach()
    N = mask.shape[1]
    if g.rel is not None:
        tile_c = N if N <= DENSE_MATCH_MAX_N else DENSE_TILE_C
        W = _tiled_cut_weights(g.rel, h, tile_c)
        return handshake_matching_dense(W, mask, rounds=rounds)
    if N <= DENSE_MATCH_MAX_N:
        W = _tiled_cut_weights(_list_relation(g.nbr), h, N)
        return handshake_matching_dense(W, mask, rounds=rounds)
    return list_matching(h, g.nbr, mask, rounds=rounds)
