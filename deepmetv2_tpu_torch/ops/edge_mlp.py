"""The DRN's fused edge-MLP EdgeConv in plain PyTorch (the JAX package's
``ops/pallas/edge_mlp.py``).

Per round the DRN computes ``out_i = aggr_j BN(elu(elu([x_i ‖ x_j − x_i]·W0
+ b0)·W1 + b1))`` with BatchNorm over the valid edge messages.  Two moves
keep the ``[B, N, K, ·]`` edge tensors out of device memory:

* the first layer factors: with ``W0 = [W_self; W_diff]`` the edge input is
  ``a_i + x_j·W_diff`` where ``a = x·(W_self − W_diff) + b0`` is node-level;
* BatchNorm is a per-channel affine ``coef·h + shift``, so it commutes
  through the aggregation: a sum becomes ``coef·Σh + deg·shift`` and a max
  ``coef·max h + shift`` (``min`` where ``coef < 0``), and the batch
  statistics are the plain sums Σh, Σh² over valid edges.

The kernel (``edge_mlp_fwd_torch`` here, csrc/edge_mlp.cu on the card)
therefore emits only node-level reductions of the raw messages and the two
statistics rows; ``bn_combine`` applies the affine around it in torch, as
the JAX package does in XLA.

The backward (``edge_mlp_bwd_torch``, the kernel ``edge_mlp_bwd``) is
written out as the TPU kernel's ``_bwd_kernel`` computes it: it recomputes
the messages, splits a max or min cotangent evenly among the slots that
tie with the forward's result, folds in the statistics' cotangent, and
returns the gradients of a, x, W_diff, W1 and b1.  The first layer is
linear in x_j, so its gradients are products per node, not per edge: with
``D[j] = Σ dz0`` over the valid slots that gather row j (the gather's
adjoint, ``slot_sum_torch``), ``dx = D·W_diffᵀ`` and ``dW_diff = Xᵀ·D``.
``D`` is returned too (``dzs``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.nn.core import elu
from deepmetv2_tpu_torch.ops.segment import gather_neighbors

MAX_DIM = 128   # csrc/edge_mlp.cu: K, H, F1 and H2 each at most 128


def supported(k: int, h: int, f1: int, h2: int) -> bool:
    """The widths and slot counts the kernel takes (csrc/edge_mlp.cu): K,
    H, F1 and H2 each in 1..MAX_DIM (a node's slots fit one edge tile)."""
    return all(1 <= d <= MAX_DIM for d in (k, h, f1, h2))


def proj_torch(x: torch.Tensor, w_diff: torch.Tensor) -> torch.Tensor:
    """The first layer's per-node term ``P = x·W_diff [B, N, F1]``."""
    return torch.matmul(x, w_diff)


def node_grads_torch(x: torch.Tensor, dzs: torch.Tensor,
                     w_diff: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first layer's gradients from the per-node sums ``dzs [B, N,
    F1]`` of dz0: ``(dx = dzs·W_diffᵀ [B, N, H], dW_diff = Xᵀ·dzs [H,
    F1])``."""
    return (torch.matmul(dzs, w_diff.t()),
            torch.einsum("bnh,bnf->hf", x, dzs))


def messages_torch(a: torch.Tensor, x: torch.Tensor, nbr: Neighborhood,
                   w_diff: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor):
    """Every slot's message and what it is made of: ``(xj, z0, e0, z1, h)``
    with ``xj [B, N, K, H]`` the gathered rows, ``z0 = a_i + x_j·W_diff``,
    ``e0 = elu(z0)``, ``z1 = e0·W1 + b1`` and ``h = elu(z1) [B, N, K, H2]``
    (masked slots included; the callers mask them)."""
    xj = gather_neighbors(x, nbr)
    z0 = torch.matmul(xj, w_diff) + a[:, :, None, :]
    e0 = elu(z0)
    z1 = torch.matmul(e0, w1) + b1
    return xj, z0, e0, z1, elu(z1)


def edge_mlp_fwd_torch(a: torch.Tensor, x: torch.Tensor, nbr: Neighborhood,
                       w_diff: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor, aggr: str
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]:
    """Messages ``h = elu(elu(a_i + x_j·W_diff)·W1 + b1)`` over each node's
    valid slots, reduced per node: ``(Σh, None, stats)`` for 'add' and
    'mean', ``(max h, min h, stats)`` for 'max' (±inf on rows with no valid
    slot), with ``stats [2, H2]`` = (Σh, Σh²) over all valid edges."""
    h = messages_torch(a, x, nbr, w_diff, w1, b1)[-1]          # [B,N,K,H2]
    m = nbr.mask[..., None]
    hm = torch.where(m, h, torch.zeros_like(h))
    stats = torch.stack([hm.sum(dim=(0, 1, 2)), (hm * hm).sum(dim=(0, 1, 2))])
    if aggr == "max":
        inf = torch.full_like(h, float("inf"))
        return (torch.where(m, h, -inf).amax(dim=2),
                torch.where(m, h, inf).amin(dim=2), stats)
    if aggr in ("add", "mean"):
        return hm.sum(dim=2), None, stats
    raise ValueError(f"unknown aggr {aggr!r}")


def delu(z: torch.Tensor) -> torch.Tensor:
    """elu'(z): 1 for z > 0, exp(z) otherwise."""
    safe = torch.where(z > 0, torch.zeros_like(z), z)
    return torch.where(z > 0, torch.ones_like(z), torch.exp(safe))


class EdgeMLPGrads(NamedTuple):
    """The backward's outputs: ``da [B, N, F1]``, ``dx [B, N, H]``, ``dzs
    [B, N, F1]`` (each row's sum of the first layer's pre-activation
    gradients dz0 over the valid slots that gather it), ``dw_diff [H,
    F1]``, ``dw1 [F1, H2]``, ``db1 [H2]``."""

    da: torch.Tensor
    dx: torch.Tensor
    dzs: torch.Tensor
    dw_diff: torch.Tensor
    dw1: torch.Tensor
    db1: torch.Tensor


def reverse_slots(nbr: Neighborhood) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transpose of a neighbour list, for summing per-slot gradients
    onto their sources without atomics: ``(order [B, N·K] int32, offsets
    [B, N + 1] int32)`` where ``order[b, offsets[b, j]:offsets[b, j + 1]]``
    are the flat slots ``i·K + k`` whose valid entry points at j, in
    ascending order (a stable sort of the valid slots by target).  The
    plain version of ops/cuda/edge_mlp.py:reverse_index."""
    B, N, K = nbr.idx.shape
    key = torch.where(nbr.mask, nbr.idx.to(torch.int64),
                      torch.full_like(nbr.idx, N, dtype=torch.int64))
    key = key.reshape(B, N * K)
    order = torch.argsort(key, dim=1, stable=True)
    sorted_key = torch.gather(key, 1, order)
    targets = torch.arange(N + 1, device=key.device, dtype=torch.int64)
    offsets = torch.searchsorted(sorted_key,
                                 targets[None, :].expand(B, N + 1).contiguous())
    return order.to(torch.int32), offsets.to(torch.int32)


def slot_sum_torch(ds: torch.Tensor, nbr: Neighborhood) -> torch.Tensor:
    """``out[b, j] = Σ ds[b, i, k]`` over the valid slots (i, k) with
    ``idx[b, i, k] = j``: the adjoint of the neighbour gather."""
    B, N, K, C = ds.shape
    rows = (nbr.idx.to(torch.int64)
            + N * torch.arange(B, device=ds.device)[:, None, None])
    m = nbr.mask.reshape(-1)
    out = torch.zeros((B * N, C), dtype=ds.dtype, device=ds.device)
    out.index_add_(0, rows.reshape(-1)[m], ds.reshape(-1, C)[m])
    return out.reshape(B, N, C)


def edge_mlp_bwd_torch(a: torch.Tensor, x: torch.Tensor, nbr: Neighborhood,
                       w_diff: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor, aggr: str, agg0: torch.Tensor,
                       agg1: Optional[torch.Tensor], g0: torch.Tensor,
                       g1: Optional[torch.Tensor], gst: torch.Tensor
                       ) -> EdgeMLPGrads:
    """Gradients of ``edge_mlp_fwd_torch``'s outputs, given their
    cotangents ``g0``, ``g1`` (max only) and ``gst [2, H2]``, written out as
    the TPU kernel's backward (ops/pallas/edge_mlp.py:128-177).  For 'max'
    the slots whose recomputed message equals the forward's ``agg0`` (or
    ``agg1``) share its cotangent evenly; the statistics' cotangent reaches
    every valid edge as ``gst[0] + 2·h·gst[1]``."""
    _, z0, e0, z1, h = messages_torch(a, x, nbr, w_diff, w1, b1)
    m = nbr.mask[..., None]
    zero = torch.zeros_like(h)
    if aggr == "max":
        tie0 = (h == agg0[:, :, None, :]) & m
        tie1 = (h == agg1[:, :, None, :]) & m
        c0 = torch.clamp(tie0.to(h.dtype).sum(dim=2), min=1.0)
        c1 = torch.clamp(tie1.to(h.dtype).sum(dim=2), min=1.0)
        dh = (torch.where(tie0, (g0 / c0)[:, :, None, :], zero)
              + torch.where(tie1, (g1 / c1)[:, :, None, :], zero))
    elif aggr in ("add", "mean"):
        dh = g0[:, :, None, :].expand_as(h)
    else:
        raise ValueError(f"unknown aggr {aggr!r}")
    dh = torch.where(m, dh + gst[0] + 2.0 * h * gst[1], zero)
    dz1 = dh * delu(z1)
    dw1 = torch.einsum("bnkf,bnko->fo", e0, dz1)
    db1 = dz1.sum(dim=(0, 1, 2))
    dz0 = torch.matmul(dz1, w1.t()) * delu(z0)
    dzs = slot_sum_torch(dz0, nbr)
    dx, dw_diff = node_grads_torch(x, dzs, w_diff)
    return EdgeMLPGrads(dz0.sum(dim=2), dx, dzs, dw_diff, dw1, db1)


def bn_combine(agg0: torch.Tensor, agg1: Optional[torch.Tensor],
               stats: torch.Tensor, edge_mask: torch.Tensor,
               gamma: torch.Tensor, beta: torch.Tensor,
               run_mean: torch.Tensor, run_var: torch.Tensor, train: bool,
               aggr: str, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out [B, N, H2], mean, var)``: BatchNorm commuted through the
    aggregation (edge_mlp.py:361-386).  ``train`` normalizes with the
    batch statistics (biased variance) and returns them; otherwise the
    running ones are used and returned.  Rows without a valid slot are 0.
    In a mesh step the edge count and the statistics rows are sums over
    the ranks that hold the global batch (parallel/context.py:batch_sum),
    as in nn/core.py:masked_moments."""
    from deepmetv2_tpu_torch.parallel.context import batch_sum

    deg = edge_mask.to(agg0.dtype).sum(dim=-1)                # [B, N]
    if train:
        total = batch_sum() or (lambda t: t)
        n = torch.clamp(total(deg.sum()), min=1.0)
        stats = total(stats)
        mean = stats[0] / n
        var = torch.clamp(stats[1] / n - mean * mean, min=0.0)
    else:
        mean, var = run_mean, run_var
    coef = gamma * torch.rsqrt(var + eps)
    shift = beta - mean * coef
    has = (deg > 0)[..., None]
    zero = torch.zeros_like(agg0)
    if aggr == "max":
        # empty rows hold ±inf sentinels: zero them before the affine
        maxh = torch.where(has, agg0, zero)
        minh = torch.where(has, agg1, zero)
        picked = torch.where(coef > 0, maxh, minh)
        out = torch.where(has, picked * coef + shift, zero)
    elif aggr == "add":
        out = torch.where(has, agg0 * coef + deg[..., None] * shift, zero)
    elif aggr == "mean":
        d = torch.clamp(deg, min=1.0)[..., None]
        out = torch.where(has, (agg0 / d) * coef + shift, zero)
    else:
        raise ValueError(f"unknown aggr {aggr!r}")
    return out, mean, var
