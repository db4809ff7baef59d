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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.nn.core import elu
from deepmetv2_tpu_torch.ops.segment import gather_neighbors

MAX_DIM = 128   # csrc/edge_mlp.cu: H, F1 and H2 each at most 128


def supported(k: int, h: int, f1: int, h2: int) -> bool:
    """The widths and slot counts the kernel takes (csrc/edge_mlp.cu): at
    least one slot, and H, F1, H2 each in 1..MAX_DIM."""
    return k >= 1 and all(1 <= d <= MAX_DIM for d in (h, f1, h2))


def edge_mlp_fwd_torch(a: torch.Tensor, x: torch.Tensor, nbr: Neighborhood,
                       w_diff: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor, aggr: str
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]:
    """Messages ``h = elu(elu(a_i + x_j·W_diff)·W1 + b1)`` over each node's
    valid slots, reduced per node: ``(Σh, None, stats)`` for 'add' and
    'mean', ``(max h, min h, stats)`` for 'max' (±inf on rows with no valid
    slot), with ``stats [2, H2]`` = (Σh, Σh²) over all valid edges."""
    xj = gather_neighbors(x, nbr)                              # [B,N,K,H]
    z0 = torch.matmul(xj, w_diff) + a[:, :, None, :]
    h = elu(torch.matmul(elu(z0), w1) + b1)                    # [B,N,K,H2]
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


def bn_combine(agg0: torch.Tensor, agg1: Optional[torch.Tensor],
               stats: torch.Tensor, edge_mask: torch.Tensor,
               gamma: torch.Tensor, beta: torch.Tensor,
               run_mean: torch.Tensor, run_var: torch.Tensor, train: bool,
               aggr: str, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out [B, N, H2], mean, var)``: BatchNorm commuted through the
    aggregation (edge_mlp.py:361-386).  ``train`` normalizes with the
    batch statistics (biased variance) and returns them; otherwise the
    running ones are used and returned.  Rows without a valid slot are 0."""
    deg = edge_mask.to(agg0.dtype).sum(dim=-1)                # [B, N]
    n = torch.clamp(deg.sum(), min=1.0)
    if train:
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
