"""The DRN's fused edge-MLP EdgeConv with its edge passes as Hopper kernels
(``csrc/edge_mlp.cu``), the counterpart of the JAX package's
``ops/pallas/edge_mlp.py:edge_mlp_conv``, forward and backward.

``edge_mlp_fwd`` and ``edge_mlp_bwd`` launch their kernels for a CUDA
tensor and take the plain versions (ops/edge_mlp.py: ``edge_mlp_fwd_torch``,
``edge_mlp_bwd_torch``) for a CPU tensor; so do ``edge_mlp_proj`` and
``edge_mlp_node_grads``, the per-node kernels both passes are built from
(the first layer x·W_diff, and its gradients dx and dW_diff), and
``reverse_index``, the lists' transpose the backward sums through.  A CUDA
tensor never reaches a plain version, and a failed build or launch
raises.  ``EdgeMLP`` is the
``torch.autograd.Function`` that pairs them on both devices.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.ops.edge_mlp import (MAX_DIM, EdgeMLPGrads,
                                              bn_combine, edge_mlp_bwd_torch,
                                              edge_mlp_fwd_torch,
                                              node_grads_torch, proj_torch,
                                              reverse_slots, supported)

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 12 + [_I] * 7 + [_P]
_BWD_ARGS = [_P] * 24 + [_I] * 7 + [_P]
_PROJ_ARGS = [_P] * 3 + [_I] * 3 + [_P]
_NODE_ARGS = [_P] * 6 + [_I] * 3 + [_P]
def _layout(B: int, N: int, K: int, F1: int) -> Tuple[int, int, int, int]:
    """The kernels' scratch shapes (csrc/edge_mlp.cu: edge_mlp_layout):
    ``(F1s, groups, node_blocks, chunks)``, F1s the row stride of the first
    layer's per-node term and of the per-slot dz0 rows, then the rows of
    the edge kernels' partial sums (one per node group) and of the node
    kernel's, and the reverse index's slot chunks per event."""
    out = (ctypes.c_int * 4)()
    err = build.function("edge_mlp", "edge_mlp_layout", [_I] * 4 + [_P])(
        B, N, K, F1, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"edge_mlp_layout failed: cudaError {err}")
    return tuple(out)


def reverse_index(nbr: Neighborhood) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order [B, N·K], offsets [B, N + 1])``, int32: the transpose of the
    lists as ``reverse_slots`` gives it (each target's valid slots
    ``i·K + k`` in ascending order), by the reverse-index kernels of
    csrc/edge_mlp.cu (a stable counting sort; N at most 8192); on the CPU
    ``reverse_slots`` itself.  On the card only each event's first
    ``offsets[b, N]`` entries of ``order`` are written."""
    if build.on_cpu("reverse_index", nbr.idx):
        return reverse_slots(nbr)
    B, N, K = nbr.idx.shape
    idx, mask = nbr.idx.contiguous(), nbr.mask.contiguous()
    dev = idx.device
    i32 = dict(dtype=torch.int32, device=dev)
    hist = torch.empty((B, _layout(B, N, K, 1)[3], N), **i32)
    cnt = torch.empty((B, N), **i32)
    order = torch.empty((B, N * K), **i32)
    offsets = torch.empty((B, N + 1), **i32)
    build.launch(build.function("edge_mlp", "edge_mlp_reverse",
                                [_P] * 6 + [_I] * 3 + [_P]), dev,
                 idx.data_ptr(), mask.data_ptr(), hist.data_ptr(),
                 cnt.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                 B, N, K)
    return order, offsets


def _check(name: str, aggr: str, args, nbr: Neighborhood, *node) -> None:
    """Raise on what the kernels do not take: ``args`` = (a [B, N, F1], x
    [B, N, H], w_diff [H, F1], w1 [F1, H2], b1 [H2]) f32, ``node`` further
    [B, N, H2] f32 tensors, idx int32 and mask bool [B, N, K], all on x's
    device, K and the widths at most MAX_DIM."""
    if aggr not in ("add", "mean", "max"):
        raise ValueError(f"unknown aggr {aggr!r}")
    a, x, w_diff, w1, b1 = args
    B, N, H = x.shape
    K = nbr.idx.shape[-1]
    F1, H2 = w1.shape
    shapes = [(a, (B, N, F1)), (w_diff, (H, F1)), (b1, (H2,)),
              (nbr.idx, (B, N, K)), (nbr.mask, (B, N, K))]
    shapes += [(t, (B, N, H2)) for t in node]
    for t, want in shapes:
        if tuple(t.shape) != want or t.device != x.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, want "
                             f"{want} on {x.device}")
    if any(t.dtype != torch.float32 for t in tuple(args) + tuple(node)):
        raise TypeError(f"{name}: a, x and the weights must be float32")
    if nbr.idx.dtype != torch.int32 or nbr.mask.dtype != torch.bool:
        raise TypeError(f"{name}: idx must be int32 and mask bool")
    if not supported(K, H, F1, H2):
        raise ValueError(f"{name}: K, H, F1, H2 = {K}, {H}, {F1}, {H2}; each "
                         f"must be in 1..{MAX_DIM}")


def edge_mlp_proj(x: torch.Tensor, w_diff: torch.Tensor) -> torch.Tensor:
    """The first layer's per-node term ``P = x·W_diff [B, N, F1]`` by the
    kernel that both edge passes start with (``proj_torch`` on the CPU)."""
    if build.on_cpu("edge_mlp_proj", x):
        return proj_torch(x, w_diff)
    B, N, H = x.shape
    F1 = w_diff.shape[1]
    x, w_diff = x.detach().contiguous(), w_diff.detach().contiguous()
    P = torch.empty((B, N, _layout(B, N, 1, F1)[0]),
                    dtype=torch.float32, device=x.device)
    build.launch(build.function("edge_mlp", "edge_mlp_proj", _PROJ_ARGS),
                 x.device, x.data_ptr(), w_diff.data_ptr(), P.data_ptr(),
                 B * N, H, F1)
    return P[..., :F1]


def edge_mlp_node_grads(x: torch.Tensor, dzs: torch.Tensor,
                        w_diff: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dW_diff)`` from the per-node sums of dz0 by the kernels that
    end the backward (``node_grads_torch`` on the CPU)."""
    if build.on_cpu("edge_mlp_node_grads", x):
        return node_grads_torch(x, dzs, w_diff)
    B, N, H = x.shape
    F1 = w_diff.shape[1]
    x, dzs, w_diff = (t.detach().contiguous() for t in (x, dzs, w_diff))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((B, N, H), **f32)
    dw_diff = torch.empty((H, F1), **f32)
    partial = torch.empty((_layout(B, N, 1, F1)[2], H * F1),
                          **f32)
    build.launch(build.function("edge_mlp", "edge_mlp_node_grads",
                                _NODE_ARGS), x.device,
                 dzs.data_ptr(), x.data_ptr(), w_diff.data_ptr(),
                 dx.data_ptr(), partial.data_ptr(), dw_diff.data_ptr(),
                 B * N, H, F1)
    return dx, dw_diff


def edge_mlp_fwd(a: torch.Tensor, x: torch.Tensor, nbr: Neighborhood,
                 w_diff: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 aggr: str) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                     torch.Tensor]:
    """``(agg0, agg1, stats)`` of the edge messages (see
    ops/edge_mlp.py:edge_mlp_fwd_torch): ``a [B, N, F1]``, ``x [B, N, H]``,
    ``nbr`` ``[B, N, K]``, ``w_diff [H, F1]``, ``w1 [F1, H2]``, ``b1
    [H2]``, all f32 but the int32 indices and bool mask.  On the card: the
    per-node first layer, the edge kernel, and the block-ordered sum of its
    statistics partials."""
    if build.on_cpu("edge_mlp_fwd", x):
        return edge_mlp_fwd_torch(a, x, nbr, w_diff, w1, b1, aggr)
    args = (a, x, w_diff, w1, b1)
    _check("edge_mlp_fwd", aggr, args, nbr)
    B, N, H = x.shape
    K = nbr.idx.shape[-1]
    F1, H2 = w1.shape
    a, x, w_diff, w1, b1, idx, mask = (
        t.detach().contiguous() for t in args + (nbr.idx, nbr.mask))
    dev = x.device
    F1s, groups = _layout(B, N, K, F1)[:2]
    f32 = dict(dtype=torch.float32, device=dev)
    P = torch.empty((B, N, F1s), **f32)
    agg0 = torch.empty((B, N, H2), **f32)
    agg1 = torch.empty_like(agg0) if aggr == "max" else None
    partial = torch.empty((groups, 2, H2), **f32)
    stats = torch.empty((2, H2), **f32)
    build.launch(build.function("edge_mlp", "edge_mlp_fwd", _FWD_ARGS), dev,
                 a.data_ptr(), x.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                 w_diff.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 P.data_ptr(), agg0.data_ptr(),
                 agg1.data_ptr() if agg1 is not None else None,
                 partial.data_ptr(), stats.data_ptr(),
                 B, N, K, H, F1, H2, int(aggr == "max"))
    edge_mlp_fwd.launches += 1
    return agg0, agg1, stats


build.counted(edge_mlp_fwd)


def edge_mlp_bwd(a: torch.Tensor, x: torch.Tensor, nbr: Neighborhood,
                 w_diff: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 aggr: str, agg0: torch.Tensor, agg1: Optional[torch.Tensor],
                 g0: torch.Tensor, g1: Optional[torch.Tensor],
                 gst: torch.Tensor) -> EdgeMLPGrads:
    """Gradients of ``edge_mlp_fwd`` (see ops/edge_mlp.py:edge_mlp_bwd_torch)
    from the forward's inputs and outputs (``agg0``, ``agg1``: the tie
    references of 'max') and the cotangents ``g0``, ``g1``, ``gst``.  On the
    card: the per-node first layer again, the edge kernel (da, dW1, db1 and
    each valid slot's dz0 row), the sum of those rows onto their sources
    through the reverse index (``reverse_index``: dzs), the per-node
    products dx and dW_diff, and the block-ordered sum of the
    weight-gradient partials."""
    if build.on_cpu("edge_mlp_bwd", x):
        return edge_mlp_bwd_torch(a, x, nbr, w_diff, w1, b1, aggr, agg0, agg1,
                                  g0, g1, gst)
    args = (a, x, w_diff, w1, b1)
    maxmode = aggr == "max"
    node = (agg0, g0) + ((agg1, g1) if maxmode else ())
    _check("edge_mlp_bwd", aggr, args, nbr, *node)
    B, N, H = x.shape
    K = nbr.idx.shape[-1]
    F1, H2 = w1.shape
    if tuple(gst.shape) != (2, H2) or gst.dtype != torch.float32:
        raise ValueError(f"edge_mlp_bwd: gst {tuple(gst.shape)} "
                         f"{gst.dtype}, want ({2}, {H2}) float32")
    a, x, w_diff, w1, b1, idx, mask, agg0, g0, gst = (
        t.detach().contiguous()
        for t in args + (nbr.idx, nbr.mask, agg0, g0, gst))
    if maxmode:
        agg1, g1 = agg1.detach().contiguous(), g1.detach().contiguous()
    dev = x.device
    F1s, groups, nodeblk, _ = _layout(B, N, K, F1)
    f32 = dict(dtype=torch.float32, device=dev)
    order, offsets = reverse_index(Neighborhood(idx, mask))
    P = torch.empty((B, N, F1s), **f32)
    dz0 = torch.empty((B, N, K, F1s), **f32)
    partial_e = torch.empty((groups, F1 * H2 + H2), **f32)
    partial_n = torch.empty((nodeblk, H * F1), **f32)
    da = torch.empty((B, N, F1), **f32)
    dzs = torch.empty((B, N, F1), **f32)
    dx = torch.empty((B, N, H), **f32)
    dw_diff = torch.empty((H, F1), **f32)
    dw1 = torch.empty((F1, H2), **f32)
    db1 = torch.empty((H2,), **f32)
    build.launch(build.function("edge_mlp", "edge_mlp_bwd", _BWD_ARGS), dev,
                 a.data_ptr(), x.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                 w_diff.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 agg0.data_ptr(), agg1.data_ptr() if maxmode else None,
                 g0.data_ptr(), g1.data_ptr() if maxmode else None,
                 gst.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                 P.data_ptr(), dz0.data_ptr(),
                 partial_e.data_ptr(), partial_n.data_ptr(), da.data_ptr(),
                 dzs.data_ptr(), dx.data_ptr(), dw_diff.data_ptr(),
                 dw1.data_ptr(), db1.data_ptr(), B, N, K, H, F1, H2,
                 int(maxmode))
    edge_mlp_bwd.launches += 1
    return EdgeMLPGrads(da, dx, dzs, dw_diff, dw1, db1)


build.counted(edge_mlp_bwd)


class EdgeMLP(torch.autograd.Function):
    """``edge_mlp_fwd`` with ``edge_mlp_bwd`` as its backward, on either
    device: ``(agg0, agg1 or None, stats)``.  x gets the gradient through
    its gathered rows (``dzs·W_diffᵀ``); its gradient through ``a`` (and that of the
    layer's W_self and b0) is autograd's, outside this function."""

    @staticmethod
    def forward(ctx, a, x, w_diff, w1, b1, idx, mask, aggr: str):
        nbr = Neighborhood(idx, mask)
        agg0, agg1, stats = edge_mlp_fwd(a, x, nbr, w_diff, w1, b1, aggr)
        ctx.save_for_backward(a, x, w_diff, w1, b1, idx, mask, agg0, agg1)
        ctx.aggr = aggr
        return agg0, agg1, stats

    @staticmethod
    def backward(ctx, g0, g1, gst):
        a, x, w_diff, w1, b1, idx, mask, agg0, agg1 = ctx.saved_tensors
        gr = edge_mlp_bwd(a, x, Neighborhood(idx, mask), w_diff, w1, b1,
                          ctx.aggr, agg0, agg1, g0, g1, gst)
        return gr.da, gr.dx, gr.dw_diff, gr.dw1, gr.db1, None, None, None


def edge_mlp_conv(x: torch.Tensor, nbr: Neighborhood,
                  mlp: Dict[str, Dict[str, torch.Tensor]],
                  gamma: torch.Tensor, beta: torch.Tensor,
                  run_mean: torch.Tensor, run_var: torch.Tensor,
                  train: bool, aggr: str = "add", eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DRN EdgeConv: ``(out [B, N, H2], mean, var)`` with
    ``mlp = {'lin0': {w [2H, F1], b}, 'lin1': {w [F1, H2], b}}``; batch
    statistics (biased variance) in train mode, the running ones
    otherwise (see ops/edge_mlp.py).  Differentiable through
    ``EdgeMLP``."""
    H = x.shape[-1]
    w0, b0 = mlp["lin0"]["w"], mlp["lin0"]["b"]
    w_self, w_diff = w0[:H], w0[H:]
    a = torch.matmul(x, w_self - w_diff) + b0
    agg0, agg1, stats = EdgeMLP.apply(a, x, w_diff, mlp["lin1"]["w"],
                                      mlp["lin1"]["b"], nbr.idx, nbr.mask,
                                      aggr)
    return bn_combine(agg0, agg1, stats, nbr.mask, gamma, beta, run_mean,
                      run_var, train, aggr, eps)
