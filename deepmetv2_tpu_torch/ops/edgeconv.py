"""EdgeConv — the message-passing op (the JAX package's ``ops/edgeconv.py``).

GraphMETNetwork's edge MLP is one ``Linear(2H → H)``; split over the
concat ``[x_i ‖ x_j − x_i]`` it is ``a_i + c_j``, so the aggregation
factors exactly: ``max_j (a_i + c_j) = a_i + max_j c_j``, the sum is
``deg_i·a_i + Σ_j c_j`` and the mean ``a_i + mean_j c_j``.

Over a ``WindowGraph`` (window mode) 'max' goes through the ``WindowMax``
autograd function (ops/cuda/edgeconv_window.py): the Hopper kernels for a
CUDA tensor, their plain PyTorch versions for a CPU tensor, with the same
tie rule in the gradient; the window 'sum' and 'mean' are not ported
(ROADMAP A9).  Over a ``Neighborhood`` (neighbor_list mode) the conv is a
gather and masked reduce of c in plain PyTorch on either device
(``edgeconv_linear``), as the JAX package runs it in XLA; ``edgeconv_mlp``
takes any edge MLP.  The sharded halo-exchange path is ROADMAP A8.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
    window_edgeconv_linear_cuda,
)
from deepmetv2_tpu_torch.ops.segment import gather_neighbors, neighbor_reduce
from deepmetv2_tpu_torch.ops.window import WindowGraph


def edgeconv(
    x: torch.Tensor,
    graph,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    reduction: str = "max",
) -> torch.Tensor:
    """Linear-MLP EdgeConv over a ``Neighborhood`` (``edgeconv_linear``) or
    a ``WindowGraph`` ('max' only)."""
    if isinstance(graph, Neighborhood):
        return edgeconv_linear(x, graph, weight, bias, reduction)
    if not isinstance(graph, WindowGraph):
        raise NotImplementedError(
            f"EdgeConv over {type(graph).__name__}: the port has it over a "
            "Neighborhood or a WindowGraph")
    if reduction != "max":
        raise NotImplementedError(
            f"window reduction {reduction!r} is not ported yet (ROADMAP A9); "
            "only 'max'")
    return window_edgeconv_linear_cuda(x, graph, weight, bias)


def edgeconv_linear(
    x: torch.Tensor,                 # [B, N, H]
    nbr: Neighborhood,
    weight: torch.Tensor,            # [2H, Hout], rows [self; diff]
    bias: Optional[torch.Tensor],    # [Hout]
    reduction: str = "max",
) -> torch.Tensor:                   # [B, N, Hout]
    """PyG ``EdgeConv(nn=Linear(2H, Hout), aggr=reduction)`` through the
    ``a_i + c_j`` factorization, 'max', 'mean' or 'sum'; a node without a
    valid slot gives 0."""
    H = x.shape[-1]
    w_self, w_diff = weight[:H], weight[H:]
    c = torch.matmul(x, w_diff)
    a = torch.matmul(x, w_self - w_diff)
    if bias is not None:
        a = a + bias
    if reduction in ("max", "mean"):
        agg = neighbor_reduce(c, nbr, reduction)
        has = nbr.mask.any(dim=-1, keepdim=True)
        out = a + agg
        return torch.where(has, out, torch.zeros_like(out))
    if reduction == "sum":
        deg = nbr.mask.sum(dim=-1, keepdim=True).to(x.dtype)
        return deg * a + neighbor_reduce(c, nbr, "sum")
    raise ValueError(f"unknown reduction {reduction!r}")


def edgeconv_mlp(
    x: torch.Tensor,                                 # [B, N, H]
    nbr: Neighborhood,
    mlp: Callable[[torch.Tensor], torch.Tensor],     # [..., 2H] -> [..., Hout]
    reduction: str = "max",
    tile: int = 256,
) -> torch.Tensor:                                   # [B, N, Hout]
    """EdgeConv with any edge MLP, ``reduce_j mlp([x_i ‖ x_j − x_i])`` for
    'max', 'mean' or 'sum' (a node without a valid slot gives 0), over
    query tiles of ``tile`` rows so that the edge tensor is ``[B, tile, K,
    2H]``, never the whole edge set."""
    if reduction not in ("max", "mean", "sum"):
        raise ValueError(f"unknown reduction {reduction!r}")
    outs = []
    for t0 in range(0, x.shape[1], tile):
        part = Neighborhood(nbr.idx[:, t0:t0 + tile],
                            nbr.mask[:, t0:t0 + tile])
        xj = gather_neighbors(x, part)                     # [B, T, K, H]
        xi = x[:, t0:t0 + tile, None, :].expand_as(xj)
        h = mlp(torch.cat([xi, xj - xi], dim=-1))          # [B, T, K, Hout]
        m = part.mask[..., None]
        if reduction == "max":
            r = torch.amax(torch.where(m, h, torch.full_like(h, -torch.inf)),
                           dim=2)
        else:
            r = torch.where(m, h, torch.zeros_like(h)).sum(dim=2)
            if reduction == "mean":
                r = r / torch.clamp(m.sum(dim=2), min=1)
        if reduction != "sum":
            r = torch.where(m.any(dim=2), r, torch.zeros_like(r))
        outs.append(r)
    return torch.cat(outs, dim=1)
