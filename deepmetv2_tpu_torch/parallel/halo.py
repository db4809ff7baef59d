"""Edge-partitioned window EdgeConv with a halo exchange (the JAX package's
``parallel/halo.py``): an event's eta-sorted (or cell-ordered) padded node
axis is split over the ranks of a node group, and every EdgeConv layer
exchanges ``halo`` boundary rows of the per-source term c and of the
positions with the two ring neighbours.  The window max then runs on each
rank through the port's own kernels (``WindowMax``: ``window_max_fwd`` /
``window_max_bwd`` on the card, their plain versions on the CPU) on the
halo-extended rows, whose ring-end fill carries ``PAD_POS`` and so counts
as padded (the kernels' padded-row contract).

Contract: the forward equals the single-device window max bit for bit on
real rows (a max does not depend on the order of its operands), given a
halo at least the row order's in-radius span; the backward differs from
the single-device kernel's only in where a boundary source's sum is split
between its own rank's part and the part returned by the exchange, so it
is held to f32 tolerance.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import WindowMax
from deepmetv2_tpu_torch.ops.window import (WindowGraph, combine,
                                            edgeconv_terms, padded_pos)
from deepmetv2_tpu_torch.parallel.collectives import (HaloExchange,
                                                      PendingExchange)

HALO_ALIGN = 64


def halo_pad(halo: int) -> int:
    """The exchanged halo: ``halo`` rounded up to a multiple of 64."""
    return -(-halo // HALO_ALIGN) * HALO_ALIGN


def window_max_sharded(c: torch.Tensor, pos: torch.Tensor, r2: float,
                       halo: int, mesh, overlap: bool = True
                       ) -> torch.Tensor:
    """The masked window max of this rank's node shard ``c [B, n_loc, H]``,
    ``pos [B, n_loc, 2]`` (padded rows at ``PAD_POS``), with the halo
    exchanged inside the mesh's node group; ``[B, n_loc, H]``.

    ``overlap`` (used when the shard holds at least ``2·halo_pad`` rows):
    the exchange of the fused ``[c ‖ pos]`` strips is posted first, the
    kernel runs on the local shard (its interior rows, whose windows are
    local, are kept), then one batched kernel call on the two ``[B, 3h]``
    boundary strips, stacked ``[2B, 3h]``, gives the edge rows.  Otherwise
    (the serial schedule) the exchange completes and the kernel runs once
    on the halo-extended shard ``[B, h + n_loc + h]``.  In both the kernel's
    window is ``halo_pad``."""
    h = halo_pad(halo)
    B, n_loc, _ = c.shape
    if h > n_loc:
        raise ValueError(
            f"halo {h} exceeds node-shard size {n_loc} ({n_loc * mesh.n_node}"
            f" nodes / {mesh.n_node} shards): single-hop halo exchange needs "
            "shard >= halo; use fewer node shards or a larger node bucket")
    if overlap and n_loc >= 2 * h:
        pending = PendingExchange(c, pos, h, mesh)        # 1. post
        m_local = WindowMax.apply(c, pos, r2, h)           # 2. local shard
        cl, cr, pl, pr = HaloExchange.apply(c, pos, h, mesh, pending)
        # 3. left queries [0, h) see [from_left ‖ rows [0, 2h)], right
        # queries [n_loc − h, n_loc) the mirror; they sit at strip rows
        # [h, 2h) of one batched call
        strip_c = torch.cat([torch.cat([cl, c[:, :2 * h]], 1),
                             torch.cat([c[:, -2 * h:], cr], 1)], 0)
        strip_p = torch.cat([torch.cat([pl, pos[:, :2 * h]], 1),
                             torch.cat([pos[:, -2 * h:], pr], 1)], 0)
        m_strip = WindowMax.apply(strip_c, strip_p, r2, h)
        return torch.cat([m_strip[:B, h:2 * h], m_local[:, h:n_loc - h],
                          m_strip[B:, h:2 * h]], 1)
    cl, cr, pl, pr = HaloExchange.apply(c, pos, h, mesh, None)
    m = WindowMax.apply(torch.cat([cl, c, cr], 1),
                        torch.cat([pl, pos, pr], 1), r2, h)
    return m[:, h:h + n_loc]


def window_edgeconv_linear_sharded(x: torch.Tensor, g: WindowGraph,
                                   weight: torch.Tensor,
                                   bias: Optional[torch.Tensor],
                                   mesh) -> torch.Tensor:
    """Edge-partitioned EdgeConv(linear, max) of this rank's node shard:
    the GEMMs local (float32), ``pos = PAD_POS`` at padded rows, the
    aggregation by ``window_max_sharded``; ``has · (a + m)``, 0 at padded
    rows and at rows with no neighbour."""
    a, c = edgeconv_terms(x, weight, bias)
    m = window_max_sharded(c, padded_pos(g.etaphi, g.mask),
                           float(g.r) ** 2, g.halo, mesh)
    return combine(a, m, g.mask)
