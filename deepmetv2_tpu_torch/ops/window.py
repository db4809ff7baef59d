"""Implicit windowed EdgeConv in plain PyTorch (the JAX package's
``ops/window.py``).

For eta-sorted events every radius-graph neighbour of node i lies within
``halo`` index positions, so the EdgeConv-max aggregation over the
factorized message a_i + c_w (ops/edgeconv.py) is a masked window max:

    out_i = a_i + max_{w in [i-halo, i+halo], adj(i, w)} c_w

with adj(i, w) = (η_i−η_w)² + (φ_i−φ_w)² < r², no φ wrap (reference
train.py:47).  This module is the CPU path and the oracle of the CUDA
kernels (ops/cuda/edgeconv_window.py), forward and backward: both round
the predicate the same way, one IEEE operation at a time, a max selects
an input exactly, and the backward sums in the same order, so kernel and
plain version agree bit for bit.  The values may be float32 or bfloat16
(``ModelConfig.compute_dtype``); the coordinates and the predicate stay
float32, and the backward sums in float32 whatever the values' type.
The window 'sum' and 'mean' (``window_sum_torch``) have no kernel, as the
JAX package runs them in XLA.

Padded rows.  The kernels take no mask: a row is padded when its eta is
at least ``PAD_POS / 2`` (``padded_rows``; the wrapper puts padded rows at
``PAD_POS``).  A padded query row gets −inf in the forward and a padded
source is never selected; in the backward a padded source gets 0 and a
padded query contributes nothing.  ``window_chunks_needed`` is the
kernels' eta/phi chunk prune, the oracle of which source chunks they
visit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F


PAD_POS = 1e9   # coordinate of padded rows: never adjacent to a real row


@dataclasses.dataclass(frozen=True)
class WindowGraph:
    """Implicit radius graph over eta-sorted padded events."""

    etaphi: torch.Tensor  # [B, N, 2]
    mask: torch.Tensor    # [B, N]
    r: float = 0.4
    halo: int = 128


def adjacent(qe, qp, se, sp, r2: float) -> torch.Tensor:
    """The adjacency predicate ``de*de + dp*dp < r2``.  Eager torch rounds
    each operation separately (no fused multiply-add), as the kernel's
    ``__fsub_rn``/``__fmul_rn``/``__fadd_rn`` do; ``r2`` is compared in f32.
    Symmetric in (q, s): negating a difference does not change its square."""
    de = qe - se
    dp = qp - sp
    return de * de + dp * dp < r2


def padded_pos(etaphi: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[B, N, 2]``: ``etaphi`` at the real rows of ``mask`` and
    ``PAD_POS`` at the others, the coordinates the kernels take."""
    return torch.where(mask[..., None], etaphi,
                       torch.full_like(etaphi, PAD_POS))


def padded_rows(pos: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` bool: the rows of ``pos [B, N, 2]`` whose eta is at least
    ``PAD_POS / 2`` (the TPU kernel's own test of a padded coordinate)."""
    return pos[..., 0] >= PAD_POS / 2


def window_max_torch(
    c: torch.Tensor,       # [B, N, H]
    pos: torch.Tensor,     # [B, N, 2]
    mask: torch.Tensor,    # [B, N]
    r2: float,
    halo: int,
) -> torch.Tensor:
    """``m[b,i,:] = max c[b,w,:]`` over w in [i−halo, i+halo] ∩ [0, N) with
    mask[i], mask[w] and adj(i, w); −inf where there is none.  With
    ``mask = ~padded_rows(pos)`` it is the kernel's function: −inf at a
    padded query row, and a padded source never selected.

    Walks the offsets d = −halo..halo over c padded by halo rows of −inf
    on each side: one select and one max of [B, N, H] per offset.  Written
    without ``out=`` so that autograd can run through it (torch's maximum
    splits the gradient at a tie; ``window_max_bwd_torch`` is the
    backward with the kernel's tie rule)."""
    neg = torch.tensor(float("-inf"), dtype=c.dtype, device=c.device)
    m = torch.full_like(c, float("-inf"))
    for cs, adj in _window_sources(c, pos, mask, r2, halo, float("-inf")):
        m = torch.maximum(m, torch.where(adj[..., None], cs, neg))
    return m


def _window_sources(c, pos, mask, r2: float, halo: int, fill: float):
    """For each offset d = −halo..halo in turn: (c of the sources i + d,
    [B, N, H], ``fill`` past either end; adj(i, i + d) ∧ mask[i] ∧
    mask[i + d], [B, N])."""
    N = c.shape[1]
    w = min(halo, N - 1)
    cp = F.pad(c, (0, 0, w, w), value=fill)
    ep = F.pad(pos[..., 0], (w, w))
    pp = F.pad(pos[..., 1], (w, w))
    mp = F.pad(mask, (w, w), value=False)
    for d in range(-w, w + 1):          # sources i + d
        s = slice(w + d, w + d + N)
        yield cp[:, s], (adjacent(pos[..., 0], pos[..., 1], ep[:, s],
                                  pp[:, s], r2) & mask & mp[:, s])


def window_sum_torch(
    c: torch.Tensor,       # [B, N, H]
    pos: torch.Tensor,     # [B, N, 2]
    mask: torch.Tensor,    # [B, N]
    r2: float,
    halo: int,
):
    """``(acc, deg)``: ``acc[b,i,:] = Σ c[b,w,:]`` over the sources w of
    ``window_max_torch`` (0 where there is none), in ascending w, and
    ``deg[b,i]`` their number (int32).  Differentiable by autograd."""
    acc = torch.zeros_like(c)
    deg = torch.zeros(c.shape[:2], dtype=torch.int32, device=c.device)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    for cs, adj in _window_sources(c, pos, mask, r2, halo, 0.0):
        acc = acc + torch.where(adj[..., None], cs, zero)
        deg = deg + adj
    return acc, deg


def window_max_bwd_torch(
    c: torch.Tensor,       # [B, N, H] the forward's input
    pos: torch.Tensor,     # [B, N, 2] padded rows at PAD_POS
    m: torch.Tensor,       # [B, N, H] the forward's output
    g: torch.Tensor,       # [B, N, H] gradient of m
    r2: float,
    halo: int,
) -> torch.Tensor:
    """The backward of the window max with the TPU kernel's tie rule:

        dc[b,s,h] = Σ_{q ∈ [s−halo, s+halo] ∩ [0,N)}
                        [adj(q, s) ∧ c[b,s,h] == m[b,q,h]] · g[b,q,h]

    so EVERY tied source gets the full gradient of its query (torch's
    maximum would halve it at each tie).  Where m is −inf (no neighbour)
    it stands as +inf with g = 0, as in the JAX package's
    ``_window_max_bwd``.  Padded rows (``padded_rows``) take no part: a
    padded source gets 0 whatever m and g hold, and a padded query
    contributes nothing.  Each source sums its terms in ascending query
    order, which the CUDA kernel repeats, so the two agree bit for bit.
    The sums run in float32 from 0 whatever the values' type (g is cast
    first), and ``dc`` is rounded to ``c.dtype`` once at the end, as the
    TPU kernel's float32 accumulator is."""
    B, N, H = c.shape
    eta, phi = pos[..., 0], pos[..., 1]
    real = ~padded_rows(pos)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.full_like(m, float("inf")))
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    g_safe = torch.where(finite, g.float(), zero)
    dc = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
    w = min(halo, N - 1)
    for d in range(-w, w + 1):          # query q = s + d, ascending
        s = slice(max(0, -d), min(N, N - d))
        q = slice(s.start + d, s.stop + d)
        hit = ((adjacent(eta[:, q], phi[:, q], eta[:, s], phi[:, s], r2)
                & real[:, q] & real[:, s])[..., None]
               & (c[:, s] == m_safe[:, q]))
        dc[:, s] += torch.where(hit, g_safe[:, q], zero)
    return dc.to(c.dtype)


def window_chunks_needed(pos: torch.Tensor, rows: int, chunk: int, halo: int,
                         r2: float) -> torch.Tensor:
    """``[B, ceil(N/rows), n_chunks]`` bool: the kernels' eta/phi chunk
    prune.  Block t holds the rows [t·rows, (t+1)·rows) ∩ [0, N); its window
    [lo, hi) = [t·rows − halo, (t+1)·rows + halo) ∩ [0, N) is cut into
    chunks of ``chunk`` rows from lo, and n_chunks is the most any block
    has.  A chunk is needed when the block and the chunk both hold a real
    row (``padded_rows``) and their boxes, the ranges of eta and of phi
    over their real rows, are not apart on either axis.  They are apart on
    an axis when a gap ``d = lo_far − hi_near`` (one chunk's low end minus
    the other's high end) has ``d > 0`` and ``d * d >= r2``, both rounded
    in f32 as the kernels' ``__fsub_rn``/``__fmul_rn`` round them.

    No pair across such a gap is adjacent, so the prune drops no pair:
    rounding is monotone, so every pair's |de| (or |dp|) is at least d and
    its square at least d·d >= r2, and adding dp·dp >= 0 cannot round the
    sum below that.  There is no φ wrap: the metric has none.  The test
    is symmetric, so it serves the backward (source blocks, query chunks)
    as well.  Entries past a block's last chunk are False."""
    B, N, _ = pos.shape
    dev = pos.device
    nb = -(-N // rows)
    t0 = torch.arange(nb, device=dev) * rows
    lo = (t0 - halo).clamp(min=0)
    hi = (t0 + rows + halo).clamp(max=N)
    n_chunks = int(((hi - lo + chunk - 1) // chunk).max())
    k = torch.arange(n_chunks, device=dev)
    src = (lo[:, None, None] + chunk * k[:, None]
           + torch.arange(chunk, device=dev))          # [nb, n_chunks, chunk]
    qry = t0[:, None] + torch.arange(rows, device=dev)  # [nb, rows]
    real = ~padded_rows(pos)
    inf = torch.tensor(float("inf"), dtype=pos.dtype, device=dev)

    def box(idx, inside):
        """(low [B, ..., 2], high [B, ..., 2], any real [B, ...]) over the
        last axis of ``idx``."""
        idx = idx.clamp(max=N - 1)
        ok = inside & real[:, idx]
        v = pos[:, idx]
        return (torch.where(ok[..., None], v, inf).amin(-2),
                torch.where(ok[..., None], v, -inf).amax(-2), ok.any(-1))

    q_lo, q_hi, q_any = box(qry, qry < N)                  # [B, nb, 2]
    c_lo, c_hi, c_any = box(src, src < hi[:, None, None])  # [B, nb, nc, 2]

    def apart(lo_far, hi_near):
        d = lo_far - hi_near
        return (d > 0) & (d * d >= r2)

    gap = apart(c_lo, q_hi[:, :, None]) | apart(q_lo[:, :, None], c_hi)
    return q_any[..., None] & c_any & ~gap.any(-1)


def edgeconv_terms(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor],
                   dtype: Optional[torch.dtype] = None):
    """Split the linear edge MLP ``[x_i ‖ x_j − x_i] @ W + b`` into the
    per-target term ``a = x (W_self − W_diff) + b`` and the per-source term
    ``c = x W_diff`` (``weight`` is ``[2H, Hout]``, rows [self; diff]).

    ``dtype=torch.bfloat16`` is the JAX package's bf16 path
    (``window_edgeconv_linear_pallas(dtype=...)``): x, W_diff and
    W_self − W_diff are rounded to bf16, each product of them is taken in
    float32 (a product of two bf16 values is exact in float32, and the sum
    accumulates in float32), the bias is added to ``a`` in float32, and
    ``c`` is rounded to bf16 once.  Each GEMM upcasts its operands through
    its own ``.float()``, so that autograd rounds each GEMM's input
    gradient to bf16 on its own and sums the two of x in bf16, as JAX's
    transpose does; ``a`` stays float32."""
    H = x.shape[-1]
    w_self, w_diff = weight[:H], weight[H:]
    if dtype in (None, torch.float32):
        c = torch.matmul(x, w_diff)
        a = torch.matmul(x, w_self - w_diff)
    else:
        xe, wd, ws = x.to(dtype), w_diff.to(dtype), (w_self - w_diff).to(dtype)
        c = torch.matmul(xe.float(), wd.float()).to(dtype)
        a = torch.matmul(xe.float(), ws.float())
    if bias is not None:
        a = a + bias
    return a, c


def combine(a: torch.Tensor, m: torch.Tensor, mask: torch.Tensor):
    """``a + m`` where the node is real and has a neighbour, else 0 (the
    PyG empty-neighbourhood convention); ``m`` is cast to float32 first,
    as the JAX package casts its bf16 window max."""
    m = m.float()
    has = torch.isfinite(m[..., :1]) & mask[..., None]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(has, a + torch.where(has, m, zero), zero)


def window_edgeconv_linear(
    x: torch.Tensor,           # [B, N, H]
    g: WindowGraph,
    weight: torch.Tensor,      # [2H, Hout] rows [self; diff]
    bias: Optional[torch.Tensor],
    reduction: str = "max",
) -> torch.Tensor:
    """EdgeConv(linear MLP) over the implicit eta-sorted radius graph, in
    float32; equals the explicit uncapped radius graph whenever ``g.halo``
    >= data/sorting.required_halo.  'max' and 'mean' give 0 at a node
    without a neighbour ('mean' divides by max(deg, 1)); 'sum' is
    ``deg·a + Σ c`` with no such mask, as the JAX package's
    ``window_edgeconv_linear``."""
    a, c = edgeconv_terms(x, weight, bias)
    r2 = float(g.r) ** 2
    if reduction == "max":
        m = window_max_torch(c, g.etaphi, g.mask, r2, g.halo)
        return combine(a, m, g.mask)
    if reduction not in ("mean", "sum"):
        raise ValueError(f"unknown reduction {reduction!r}")
    acc, deg = window_sum_torch(c, g.etaphi, g.mask, r2, g.halo)
    deg = deg[..., None]
    if reduction == "sum":
        return deg.to(c.dtype) * a + acc
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(deg > 0, a + acc / torch.clamp(deg, min=1), zero)
