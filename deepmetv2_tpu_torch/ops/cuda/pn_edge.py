"""ParticleNet's EdgeConv edge block as Hopper kernels (``csrc/pn_edge.cu``),
forward and backward, and ``edge_block``, the op the model calls.

``pn_edge_fwd`` and ``pn_edge_bwd`` launch the kernels for CUDA tensors;
``edge_block`` takes the plain version (ops/pn_edge.py:edge_block_torch,
with autograd) for CPU tensors, and on the card ``PNEdge``, the
``torch.autograd.Function`` that pairs the two wrappers.  A CUDA tensor
never reaches the plain version, and a failed build or launch raises.

The kernels work on the rows of real edges only: they take ``cnt [B]``
(int32), the count of leading rows of each event that may hold real
nodes, and skip tiles of 128 edge rows past it.  Collation puts each
event's real candidates first, which makes that count the event's real
candidates.  Every sum is taken in a fixed order, so a call repeats bit for
bit, eagerly and under CUDA graph replay.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.ops.cuda.edge_mlp import reverse_index
from deepmetv2_tpu_torch.ops.pn_edge import EPS, edge_block_torch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 18 + [_I] * 6 + [_F, _P]
_BWD_ARGS = [_P] * 28 + [_I] * 5 + [_P]
TILE = 128      # rows of a tile (csrc/pn_edge.cu: BM)


@functools.lru_cache(maxsize=None)
def _scratch(B: int, N: int, K: int, cin: int, C: int) -> Tuple[int, int]:
    """The kernels' scratch: f32 partials and double first-stage sums."""
    out = (ctypes.c_longlong * 2)()
    build.function("pn_edge", "pn_edge_scratch", [_I] * 5 + [_P])(
        B, N, K, cin, C, ctypes.addressof(out))
    return int(out[0]), int(out[1])


def supported(N: int, C: int) -> bool:
    """The shapes the kernels take: N a multiple of the tile, and C a
    divisor of 256 (the node and slot passes give each channel a thread)."""
    return N % TILE == 0 and 0 < C <= 256 and 256 % C == 0


def _check(name: str, x: torch.Tensor, nbr: Neighborhood, cnt, n_edges,
           ws: Sequence[torch.Tensor]) -> None:
    B, N, cin = x.shape
    C = ws[1].shape[0]
    want = [(nbr.idx, (B, N, nbr.idx.shape[-1]), torch.int32),
            (nbr.mask, tuple(nbr.idx.shape), torch.bool),
            (cnt, (B,), torch.int32), (n_edges, (1,), torch.float64),
            (x, (B, N, cin), torch.float32),
            (ws[0], (2 * cin, C), torch.float32),
            (ws[1], (C, C), torch.float32), (ws[2], (C, C), torch.float32)]
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {shape} {dtype} on {x.device}")
    if not supported(N, C):
        raise ValueError(f"{name}: N={N}, C={C}; N must be a multiple of "
                         f"{TILE} and C divide 256")


def _w1cat(w1: torch.Tensor, cin: int) -> torch.Tensor:
    """``[w1a − w1b | w1b]`` ``[Cin, 2C]``: the per-node products of the
    factored first layer."""
    return torch.cat([w1[:cin] - w1[cin:], w1[cin:]], dim=1).contiguous()


def pn_edge_fwd(x: torch.Tensor, nbr: Neighborhood, cnt: torch.Tensor,
                n_edges: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                w3: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                train: bool, running: Sequence = (), eps: float = EPS
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """``(y [B, N, C], z [3, B·N·K, C], st [3, 5, C], inv_deg [B·N])``: the
    block's output, each layer before its BatchNorm (rows of skipped tiles
    unwritten), the per-layer (s, t, mean, rstd, var) and each node's 1 /
    real slots.  ``gamma``, ``beta``: ``[3, C]``; ``n_edges``: the real
    slots, float64 ``[1]``.  Without ``train`` the BatchNorm uses
    ``running``'s (mean, var) per layer."""
    _check("pn_edge_fwd", x, nbr, cnt, n_edges, (w1, w2, w3))
    B, N, cin = x.shape
    K, C = nbr.idx.shape[-1], w2.shape[0]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    npart, ntmp = _scratch(B, N, K, cin, C)
    x = x.detach().contiguous()
    gamma, beta = gamma.detach().contiguous(), beta.detach().contiguous()
    w1c = _w1cat(w1.detach(), cin)
    w2, w3 = w2.detach().contiguous(), w3.detach().contiguous()
    idx, mask = nbr.idx.contiguous(), nbr.mask.contiguous()
    st = torch.empty((3, 5, C), **f32)
    if not train:
        for layer, (mean, var) in enumerate(running):
            rstd = torch.rsqrt(var + eps)
            st[layer, 0] = gamma[layer] * rstd
            st[layer, 1] = beta[layer] - mean * st[layer, 0]
            st[layer, 2], st[layer, 3], st[layer, 4] = mean, rstd, var
    ap = torch.empty((B * N, 2 * C), **f32)
    z = torch.empty((3, B * N * K, C), **f32)
    y = torch.empty((B, N, C), **f32)
    inv_deg = torch.empty((B * N,), **f32)
    part = torch.empty((npart,), **f32)
    tmp = torch.empty((ntmp,), dtype=torch.float64, device=dev)
    sums = torch.empty((2 * C,), dtype=torch.float64, device=dev)
    build.launch(build.function("pn_edge", "pn_edge_fwd", _FWD_ARGS), dev,
                 x.data_ptr(), w1c.data_ptr(), w2.data_ptr(), w3.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), idx.data_ptr(),
                 mask.data_ptr(), cnt.data_ptr(), n_edges.data_ptr(),
                 ap.data_ptr(), z.data_ptr(), st.data_ptr(), y.data_ptr(),
                 inv_deg.data_ptr(), part.data_ptr(), tmp.data_ptr(),
                 sums.data_ptr(), B, N, K, cin, C, int(train), float(eps))
    pn_edge_fwd.launches += 1
    return y, z, st, inv_deg


build.counted(pn_edge_fwd)


def pn_edge_bwd(x: torch.Tensor, nbr: Neighborhood, cnt: torch.Tensor,
                n_edges: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                w3: torch.Tensor, gamma: torch.Tensor, z: torch.Tensor,
                st: torch.Tensor, inv_deg: torch.Tensor, gy: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``pn_edge_fwd`` in training from ``gy [B, N, C]``:
    ``(dx, dw1, dw2, dw3, dgamma [3, C], dbeta [3, C])``."""
    _check("pn_edge_bwd", x, nbr, cnt, n_edges, (w1, w2, w3))
    B, N, cin = x.shape
    K, C = nbr.idx.shape[-1], w2.shape[0]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    npart, ntmp = _scratch(B, N, K, cin, C)
    x, gy = x.detach().contiguous(), gy.detach().contiguous()
    w1t = _w1cat(w1.detach(), cin).t().contiguous()
    w2t, w3t = w2.detach().t().contiguous(), w3.detach().t().contiguous()
    idx, mask = nbr.idx.contiguous(), nbr.mask.contiguous()
    order, offsets = reverse_index(Neighborhood(idx, mask))
    dx = torch.zeros((B, N, cin), **f32)
    dw1c = torch.empty((cin, 2 * C), **f32)
    dw2, dw3 = torch.empty((C, C), **f32), torch.empty((C, C), **f32)
    dgamma, dbeta = torch.empty((3, C), **f32), torch.empty((3, C), **f32)
    g0 = torch.empty((B * N * K, C), **f32)
    g1 = torch.empty_like(g0)
    dap = torch.empty((B * N, 2 * C), **f32)
    coef = torch.empty((2 * C,), **f32)
    part = torch.empty((npart,), **f32)
    tmp = torch.empty((ntmp,), dtype=torch.float64, device=dev)
    sums = torch.empty((2 * C,), dtype=torch.float64, device=dev)
    build.launch(build.function("pn_edge", "pn_edge_bwd", _BWD_ARGS), dev,
                 x.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), w3t.data_ptr(),
                 gamma.detach().contiguous().data_ptr(), idx.data_ptr(),
                 mask.data_ptr(), cnt.data_ptr(), n_edges.data_ptr(),
                 order.data_ptr(), offsets.data_ptr(), z.data_ptr(),
                 st.data_ptr(), inv_deg.data_ptr(), gy.data_ptr(),
                 dx.data_ptr(), dw1c.data_ptr(), dw2.data_ptr(),
                 dw3.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                 g0.data_ptr(), g1.data_ptr(), dap.data_ptr(),
                 coef.data_ptr(), part.data_ptr(), tmp.data_ptr(),
                 sums.data_ptr(), B, N, K, cin, C)
    pn_edge_bwd.launches += 1
    dwa = dw1c[:, :C]
    dw1 = torch.cat([dwa, dw1c[:, C:] - dwa], dim=0)
    return dx, dw1, dw2, dw3, dgamma, dbeta


build.counted(pn_edge_bwd)


class PNEdge(torch.autograd.Function):
    """``pn_edge_fwd`` in training with ``pn_edge_bwd`` as its backward:
    ``(y, stats [3, 2, C])``, the statistics (mean, biased var per layer)
    for the running buffers, not differentiable."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, gamma, beta, idx, mask, cnt, n_edges):
        nbr = Neighborhood(idx, mask)
        y, z, st, inv_deg = pn_edge_fwd(x, nbr, cnt, n_edges, w1, w2, w3,
                                        gamma, beta, True)
        ctx.save_for_backward(x, w1, w2, w3, gamma, idx, mask, cnt, n_edges,
                              z, st, inv_deg)
        stats = st[:, 2::2]
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, w1, w2, w3, gamma, idx, mask, cnt, n_edges, z, st, inv_deg = (
            ctx.saved_tensors)
        grads = pn_edge_bwd(x, Neighborhood(idx, mask), cnt, n_edges, w1, w2,
                            w3, gamma, z, st, inv_deg, gy)
        return grads + (None,) * 4


def edge_block(x: torch.Tensor, nbr: Neighborhood, cnt: torch.Tensor,
               n_edges: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               w3: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               train: bool,
               running: Sequence[Tuple[torch.Tensor, torch.Tensor]] = ()
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The edge block (ops/pn_edge.py): ``(y [B, N, C], stats [3, 2, C])``,
    in training the batch's statistics, differentiable in ``x`` and every
    weight; in evaluation ``running``'s, no gradient on the card."""
    if build.on_cpu("pn_edge", x):
        return edge_block_torch(x, nbr, w1, w2, w3, gamma, beta, train,
                                running)
    if train:
        return PNEdge.apply(x, w1, w2, w3, gamma, beta, nbr.idx, nbr.mask,
                            cnt, n_edges)
    y = pn_edge_fwd(x, nbr, cnt, n_edges, w1, w2, w3, gamma, beta, False,
                    running)[0]
    return y, torch.stack([torch.stack(r) for r in running])
