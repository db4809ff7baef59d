"""The distributed feature-space kNN build of the node-sharded DRN (the
JAX package's ``parallel/knn.py``): the padded node axis of each event is
split over the ranks of a node group (parallel/mesh.py:shard_batch with
``shard_nodes``), and each rank finds the exact k nearest valid nodes of
its own query rows among all N.  The neighbour indices are GLOBAL node
positions, and the ``Neighborhood`` comes back sharded like the queries.

Two builds, one contract:

* ``knn_graph_sharded``: the rank all-gathers the ``[B, N, D]`` block and
  the mask once (parallel/collectives.py:gather_nodes), then takes its
  rows' top k over all N.
* ``knn_graph_sharded_ring``: the block is never whole on a rank.  The
  source shard and its mask rotate around the node ring
  (collectives.py:ring_shift, to ``(n + 1) mod N``), and each rank folds
  the visiting block into a running top k, ``[best ‖ block]``; exactly N
  folds and N rotations, the last rotation included.  The build holds
  O(B·n_loc·(D + k)) per rank besides one block's distances (the rest of
  the node-sharded round, parallel/dyn.py, holds the whole axis).

The arithmetic is the JAX sharded builds', not ``ops/graph.py``'s:
``d² = (|q|² − 2·q·s) + |s|²`` in that order, not floored at 0, with the
product ``torch.matmul`` in full f32 (callers keep TF32 off).  Both builds
compute it per source shard, ``[n_loc, n_loc]`` at a time on contiguous
blocks, so they round every pair alike.  Masked sources and queries, and
the self pair unless ``loop``, get +inf; a slot is valid iff its d² is
finite, an invalid slot's index is 0.  The selection is ``lax.top_k(−d², k)``'s: the k
smallest, and among equal d² the lower position first, taken as the first
k of a stable ascending sort (``torch.topk`` orders no ties).  Position
means the global index in the all-gather build and the visit order in the
ring, which visits ``best`` before the block and the blocks as own shard,
then shard − 1, shard − 2, ...: on an exact tie of d² across shards the
two builds may keep different neighbours (ROADMAP "Known divergences",
both packages).  No gradient flows through either build.
"""

from __future__ import annotations

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.parallel.collectives import gather_nodes, ring_shift


def _block_d2(q: torch.Tensor, q2: torch.Tensor, qm: torch.Tensor,
              q0: int, s: torch.Tensor, sm: torch.Tensor, s0: int,
              loop: bool) -> torch.Tensor:
    """``[B, nq, ns]`` d² of the queries ``q`` (first global row ``q0``,
    squared norms ``q2``, mask ``qm``) to the source block ``s`` (first
    global row ``s0``, mask ``sm``); +inf where a pair is not a candidate
    (−0.0 made +0.0, which a radix sort orders apart)."""
    d2 = (q2[:, :, None] - 2.0 * torch.matmul(q, s.transpose(1, 2))
          + (s * s).sum(dim=-1)[:, None, :])
    ok = qm[:, :, None] & sm[:, None, :]
    if not loop:
        qi = torch.arange(q0, q0 + q.shape[1], device=q.device)
        si = torch.arange(s0, s0 + s.shape[1], device=q.device)
        ok = ok & (qi[:, None] != si[None, :])
    return (d2 + 0.0).masked_fill(~ok, float("inf"))


def _first_k(d2: torch.Tensor, ids: torch.Tensor, k: int):
    """The first ``k`` of a stable ascending sort of ``d2``: ``(d², ids)``
    of the kept slots."""
    vals, order = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], torch.gather(ids, -1, order[..., :k])


def _neighborhood(d2: torch.Tensor, ids: torch.Tensor) -> Neighborhood:
    valid = torch.isfinite(d2)
    return Neighborhood(idx=torch.where(valid, ids, torch.zeros_like(ids)),
                        mask=valid)


@torch.no_grad()
def knn_graph_sharded(x: torch.Tensor, mask: torch.Tensor, k: int = 16, *,
                      mesh, loop: bool = False) -> Neighborhood:
    """Exact kNN of this rank's query rows ``x [B, n_loc, D]``, ``mask
    [B, n_loc]`` over the node group's whole axis, the block all-gathered
    once; ``Neighborhood`` ``[B, n_loc, k]`` of global indices."""
    B, n_loc, _ = x.shape
    xg, mg = gather_nodes(x, mesh), gather_nodes(mask, mesh)
    q0, q2 = mesh.node_index * n_loc, (x * x).sum(dim=-1)
    d2 = torch.cat([_block_d2(x, q2, mask, q0,
                              xg[:, s0:s0 + n_loc].contiguous(),
                              mg[:, s0:s0 + n_loc], s0, loop)
                    for s0 in range(0, xg.shape[1], n_loc)], dim=-1)
    ids = torch.arange(d2.shape[-1], dtype=torch.int32,
                       device=x.device).expand(d2.shape)
    return _neighborhood(*_first_k(d2, ids, k))


@torch.no_grad()
def knn_graph_sharded_ring(x: torch.Tensor, mask: torch.Tensor, k: int = 16,
                           *, mesh, loop: bool = False) -> Neighborhood:
    """``knn_graph_sharded``'s Neighborhood with the source blocks rotated
    around the node ring, never the whole block on one rank."""
    B, n_loc, D = x.shape
    n = mesh.node_index
    q0, q2 = n * n_loc, (x * x).sum(dim=-1)
    best_d = torch.full((B, n_loc, k), float("inf"), dtype=x.dtype,
                        device=x.device)
    best_i = torch.zeros((B, n_loc, k), dtype=torch.int32, device=x.device)
    # the visiting block and its mask travel as one message
    block = torch.cat([x, mask[..., None].to(x.dtype)], dim=-1)
    for t in range(mesh.n_node):
        s0 = ((n - t) % mesh.n_node) * n_loc               # block's owner
        d2 = _block_d2(x, q2, mask, q0, block[..., :D].contiguous(),
                       block[..., D] > 0, s0, loop)
        ids = torch.arange(s0, s0 + n_loc, dtype=torch.int32,
                           device=x.device).expand(d2.shape)
        best_d, best_i = _first_k(torch.cat([best_d, d2], dim=-1),
                                  torch.cat([best_i, ids], dim=-1), k)
        block = ring_shift(block, mesh)
    return _neighborhood(best_d, best_i)
