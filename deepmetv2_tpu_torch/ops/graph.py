"""Graph construction over padded batches (the JAX package's
``ops/graph.py``; torch_cluster's ``radius_graph`` / ``knn_graph`` at
reference train.py:48 and model/dynamic_reduction_network.py:86,94, and
PyG's ``to_undirected``).

Graphs are fixed-degree neighbour lists ``Neighborhood(idx [B, N, K], mask
[B, N, K])``: static shapes, no host sync, so a train step that builds one
can be captured as a CUDA graph.  Queries run in tiles of ``tile`` rows, so
peak memory is O(B·tile·N); a row's list does not depend on the tile.

The selection is the JAX package's ``lax.top_k(-score, k)``: the nearest k
valid candidates, and among equal d² the lower index first.  ``torch.topk``
promises no order among ties, so the selection is the first k of a stable
ascending sort of the score (+inf where invalid).  d² is summed one
rounded operation at a time in ascending axis order (no fused
multiply-add), the same on both devices;
``radius_graph``'s test is ``d² < r²`` with r² the float32 rounding of
``float(r) ** 2``, as JAX compares it.

``to_undirected`` and its helpers are integer sorts, scans and scatters,
bit for bit the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood


def _pairwise_sq_dists(q: torch.Tensor, p: torch.Tensor,
                       wrap: Optional[Sequence[float]] = None
                       ) -> torch.Tensor:
    """``[B, T, N]`` squared distances of queries ``q [B, T, D]`` to
    ``p [B, N, D]``.  With D ≤ 4 or ``wrap`` (a period per axis, 0 for
    none): the difference form, axis by axis; otherwise |a|² + |b|² − 2a·b
    in full f32 (callers keep TF32 off), floored at 0."""
    D = q.shape[-1]
    if wrap is not None or D <= 4:
        d2 = None
        for c in range(D):
            d = q[..., c, None] - p[..., None, :, c]
            w = 0.0 if wrap is None else float(np.float32(wrap[c]))
            if w > 0:
                half = float(np.float32(w) / np.float32(2.0))
                d = torch.remainder(d + half, w) - half
            d2 = d * d if d2 is None else d2 + d * d
        return d2
    qq = (q * q).sum(dim=-1)[..., :, None]
    pp = (p * p).sum(dim=-1)[..., None, :]
    qp = torch.matmul(q, p.transpose(-1, -2))
    return torch.clamp(qq + pp - 2.0 * qp, min=0.0)


def _build(pos: torch.Tensor, mask: torch.Tensor, k: int,
           r2: Optional[float], loop: bool, wrap, tile: int
           ) -> Neighborhood:
    """Each node's nearest ``k`` valid candidates (``d² < r2`` when given;
    itself only with ``loop``), ascending (d², index); slots past them are
    masked at index 0."""
    B, N, _ = pos.shape
    k_eff = min(k, N)
    jidx = torch.arange(N, device=pos.device)
    idxs, masks = [], []
    for t0 in range(0, N, tile):
        t1 = min(t0 + tile, N)
        d2 = _pairwise_sq_dists(pos[:, t0:t1], pos, wrap)       # [B, T, N]
        valid = mask[:, t0:t1, None] & mask[:, None, :]
        if r2 is not None:
            valid &= d2 < r2
        if not loop:
            valid &= (jidx[t0:t1, None] != jidx[None, :])
        # + 0.0 turns a −0.0 into +0.0: a radix sort orders them apart
        score = (d2 + 0.0).masked_fill(~valid, float("inf"))
        vals, order = torch.sort(score, dim=-1, stable=True)
        idxs.append(order[..., :k_eff].to(torch.int32))
        masks.append(vals[..., :k_eff] < float("inf"))
    idx, nmask = torch.cat(idxs, dim=1), torch.cat(masks, dim=1)
    if k_eff < k:
        pad = (0, k - k_eff)
        idx = torch.nn.functional.pad(idx, pad)
        nmask = torch.nn.functional.pad(nmask, pad)
    return Neighborhood(idx=torch.where(nmask, idx, torch.zeros_like(idx)),
                        mask=nmask)


def radius_graph(pos: torch.Tensor, mask: torch.Tensor, r: float,
                 k: int = 256, loop: bool = True,
                 wrap_axes: Optional[Tuple[float, ...]] = None,
                 tile: int = 512) -> Neighborhood:
    """Every pair within radius ``r`` (``d² < r²``), capped at the nearest
    ``k`` (``torch_cluster.radius_graph(etaphi, r, batch, loop=True,
    max_num_neighbors=255)`` at reference train.py:48, over padded
    batches).  ``wrap_axes``: a period per axis (e.g. ``(0.0, 2π)`` to wrap
    phi); None is the reference's metric."""
    r2 = float(np.float32(float(r) ** 2))
    return _build(pos, mask, k, r2, loop, wrap_axes, tile)


def knn_graph(x: torch.Tensor, mask: torch.Tensor, k: int = 16,
              loop: bool = False, tile: int = 512) -> Neighborhood:
    """The k nearest valid nodes in feature space, itself excluded unless
    ``loop`` (``torch_cluster.knn_graph(x, k, batch, loop=False)`` at
    reference model/dynamic_reduction_network.py:86,94: node i's k nearest
    message into i)."""
    return _build(x, mask, k, None, loop, None, tile)


def _invert(idx: torch.Tensor, mask: torch.Tensor, cap: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse lists ``[B, N, cap]``: node j lists every i with j in
    ``idx[i]``, in ascending i, at most ``cap`` (the rest dropped).  The
    directed edges are stably sorted by destination; an edge's rank within
    its destination's run is its slot."""
    B, N, K = idx.shape
    E = N * K
    dev = idx.device
    dst = torch.where(mask, idx, torch.full_like(idx, N)).reshape(B, E)
    sdst, order = torch.sort(dst, dim=-1, stable=True)
    ssrc = (order // K).to(torch.int32)
    starts = torch.searchsorted(
        sdst, torch.arange(N + 1, device=dev,
                           dtype=sdst.dtype).expand(B, N + 1).contiguous())
    rank = torch.arange(E, device=dev) - torch.gather(starts, 1, sdst.long())
    keep = (sdst < N) & (rank < cap)
    flat = torch.where(keep, sdst.long() * cap + rank,
                       torch.full_like(rank, N * cap))
    in_idx = torch.zeros((B, N * cap + 1), dtype=torch.int32, device=dev)
    in_idx.scatter_(1, flat, torch.where(keep, ssrc, torch.zeros_like(ssrc)))
    in_mask = torch.zeros((B, N * cap + 1), dtype=torch.bool, device=dev)
    in_mask.scatter_(1, flat, keep)
    return (in_idx[:, :N * cap].reshape(B, N, cap),
            in_mask[:, :N * cap].reshape(B, N, cap))


def _unique_prefix(vals: torch.Tensor, sentinel: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distinct values below ``sentinel`` of each row of ``vals``,
    ascending, in the first ``cap`` slots: ``(idx, mask)``, masked slots
    at 0."""
    s = torch.sort(vals, dim=-1).values
    dup = torch.cat([torch.zeros_like(s[..., :1], dtype=torch.bool),
                     s[..., 1:] == s[..., :-1]], dim=-1)
    keyed = torch.where((s < sentinel) & ~dup, s,
                        torch.full_like(s, sentinel))
    s2 = torch.sort(keyed, dim=-1).values[..., :cap]
    m = s2 < sentinel
    return torch.where(m, s2, torch.zeros_like(s2)).to(torch.int32), m


def to_undirected(nbr: Neighborhood, cap: Optional[int] = None
                  ) -> Neighborhood:
    """The edge set E ∪ Eᵀ, deduplicated, each list ascending (PyG
    ``to_undirected`` at reference model/dynamic_reduction_network.py:
    86,94).  Degree is capped at ``cap`` (default 2K): past the cap a
    node's highest-indexed neighbours go, and an edge stays only if it
    stays at both ends, so the result is symmetric."""
    B, N, K = nbr.idx.shape
    cap = 2 * K if cap is None else cap
    in_cap = 2 * cap
    sent = torch.full_like(nbr.idx, N)
    in_idx, in_mask = _invert(nbr.idx, nbr.mask, in_cap)
    both = torch.cat([torch.where(nbr.mask, nbr.idx, sent),
                      torch.where(in_mask, in_idx,
                                  torch.full_like(in_idx, N))], dim=-1)
    und_idx, und_mask = _unique_prefix(both, N, cap)
    # mutual keep: j stays in i's list iff i stayed in j's
    rev_idx, rev_mask = _invert(und_idx, und_mask, in_cap)
    merged = torch.cat([
        torch.where(und_mask, und_idx, torch.full_like(und_idx, N)),
        torch.where(rev_mask, rev_idx, torch.full_like(rev_idx, N))], dim=-1)
    ms = torch.sort(merged, dim=-1).values
    # both lists are distinct: a value seen twice is in both
    twice = (ms[..., 1:] == ms[..., :-1]) & (ms[..., 1:] < N)
    inter = torch.where(twice, ms[..., 1:], torch.full_like(ms[..., 1:], N))
    idx, mask = _unique_prefix(inter, N, cap)
    return Neighborhood(idx=idx, mask=mask)
