"""The DRN's fused edge-MLP EdgeConv with its edge pass as a Hopper kernel
(``csrc/edge_mlp.cu``), the counterpart of the JAX package's
``ops/pallas/edge_mlp.py:edge_mlp_conv`` (forward).

``edge_mlp_fwd`` launches the kernel for a CUDA tensor and takes the plain
version (ops/edge_mlp.py:edge_mlp_fwd_torch) for a CPU tensor; a CUDA
tensor never reaches the plain version, and a failed build or launch
raises.  The kernel's backward is not ported yet: on the card the pass
refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.ops.edge_mlp import (MAX_DIM, bn_combine,
                                              edge_mlp_fwd_torch)

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 11 + [_I] * 7 + [_P]


def _num_blocks(B: int, N: int) -> int:
    """Rows of the statistics partials the kernel writes."""
    return build.function("edge_mlp", "edge_mlp_num_blocks", [_I, _I])(B, N)


def edge_mlp_fwd(a: torch.Tensor, x: torch.Tensor, nbr: Neighborhood,
                 w_diff: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 aggr: str) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                     torch.Tensor]:
    """``(agg0, agg1, stats)`` of the edge messages (see
    ops/edge_mlp.py:edge_mlp_fwd_torch): ``a [B, N, F1]``, ``x [B, N, H]``,
    ``nbr`` ``[B, N, K]``, ``w_diff [H, F1]``, ``w1 [F1, H2]``, ``b1
    [H2]``, all f32 but the int32 indices and bool mask."""
    if build.on_cpu("edge_mlp_fwd", x):
        return edge_mlp_fwd_torch(a, x, nbr, w_diff, w1, b1, aggr)
    if aggr not in ("add", "mean", "max"):
        raise ValueError(f"unknown aggr {aggr!r}")
    args = (a, x, w_diff, w1, b1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "edge_mlp_fwd: the kernel's backward is not ported yet; call it "
            "under torch.no_grad()")
    B, N, H = x.shape
    K = nbr.idx.shape[-1]
    F1, H2 = w1.shape
    shapes = [(a, (B, N, F1)), (w_diff, (H, F1)), (b1, (H2,)),
              (nbr.idx, (B, N, K)), (nbr.mask, (B, N, K))]
    for t, want in shapes:
        if tuple(t.shape) != want or t.device != x.device:
            raise ValueError(f"edge_mlp_fwd: {tuple(t.shape)} on {t.device},"
                             f" want {want} on {x.device}")
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError("edge_mlp_fwd: a, x and the weights must be float32")
    if nbr.idx.dtype != torch.int32 or nbr.mask.dtype != torch.bool:
        raise TypeError("edge_mlp_fwd: idx must be int32 and mask bool")
    if max(H, F1, H2) > MAX_DIM:
        raise ValueError(f"edge_mlp_fwd: H, F1, H2 = {H}, {F1}, {H2}; each "
                         f"must be at most {MAX_DIM}")
    a, x, w_diff, w1, b1, idx, mask = (
        t.detach().contiguous() for t in args + (nbr.idx, nbr.mask))
    dev = x.device
    agg0 = torch.empty((B, N, H2), dtype=torch.float32, device=dev)
    agg1 = torch.empty_like(agg0) if aggr == "max" else None
    partial = torch.empty((_num_blocks(B, N), 2, H2), dtype=torch.float32,
                          device=dev)
    stats = torch.empty((2, H2), dtype=torch.float32, device=dev)
    build.launch(build.function("edge_mlp", "edge_mlp_fwd", _FWD_ARGS), dev,
                 a.data_ptr(), x.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                 w_diff.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 agg0.data_ptr(), agg1.data_ptr() if agg1 is not None
                 else None, partial.data_ptr(), stats.data_ptr(),
                 B, N, K, H, F1, H2, int(aggr == "max"))
    edge_mlp_fwd.launches += 1
    return agg0, agg1, stats


edge_mlp_fwd.launches = 0


def edge_mlp_conv(x: torch.Tensor, nbr: Neighborhood,
                  mlp: Dict[str, Dict[str, torch.Tensor]],
                  gamma: torch.Tensor, beta: torch.Tensor,
                  run_mean: torch.Tensor, run_var: torch.Tensor,
                  train: bool, aggr: str = "add", eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DRN EdgeConv: ``(out [B, N, H2], mean, var)`` with
    ``mlp = {'lin0': {w [2H, F1], b}, 'lin1': {w [F1, H2], b}}``; batch
    statistics (biased variance) in train mode, the running ones
    otherwise (see ops/edge_mlp.py)."""
    H = x.shape[-1]
    w0, b0 = mlp["lin0"]["w"], mlp["lin0"]["b"]
    w_self, w_diff = w0[:H], w0[H:]
    a = torch.matmul(x, w_self - w_diff) + b0
    agg0, agg1, stats = edge_mlp_fwd(a, x, nbr, w_diff, mlp["lin1"]["w"],
                                     mlp["lin1"]["b"], aggr)
    return bn_combine(agg0, agg1, stats, nbr.mask, gamma, beta, run_mean,
                      run_var, train, aggr, eps)
