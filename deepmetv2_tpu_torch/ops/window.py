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
plain version agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F


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


def window_max_torch(
    c: torch.Tensor,       # [B, N, H]
    pos: torch.Tensor,     # [B, N, 2]
    mask: torch.Tensor,    # [B, N]
    r2: float,
    halo: int,
) -> torch.Tensor:
    """``m[b,i,:] = max c[b,w,:]`` over w in [i−halo, i+halo] ∩ [0, N) with
    mask[i], mask[w] and adj(i, w); −inf where there is none.

    Walks the offsets d = −halo..halo over c padded by halo rows of −inf
    on each side: one select and one max of [B, N, H] per offset.  Written
    without ``out=`` so that autograd can run through it (torch's maximum
    splits the gradient at a tie; ``window_max_bwd_torch`` is the
    backward with the kernel's tie rule)."""
    B, N, H = c.shape
    w = min(halo, N - 1)
    neg = torch.tensor(float("-inf"), dtype=c.dtype, device=c.device)
    cp = F.pad(c, (0, 0, w, w), value=float("-inf"))
    ep = F.pad(pos[..., 0], (w, w))
    pp = F.pad(pos[..., 1], (w, w))
    mp = F.pad(mask, (w, w), value=False)
    m = torch.full_like(c, float("-inf"))
    for d in range(-w, w + 1):          # sources i + d
        s = slice(w + d, w + d + N)
        adj = (adjacent(pos[..., 0], pos[..., 1], ep[:, s], pp[:, s], r2)
               & mask & mp[:, s])[..., None]
        m = torch.maximum(m, torch.where(adj, cp[:, s], neg))
    return m


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
    ``_window_max_bwd``.  Each source sums its terms in ascending query
    order, which the CUDA kernel repeats, so the two agree bit for bit."""
    B, N, H = c.shape
    eta, phi = pos[..., 0], pos[..., 1]
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.full_like(m, float("inf")))
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    g_safe = torch.where(finite, g, zero)
    dc = torch.zeros_like(c)
    w = min(halo, N - 1)
    for d in range(-w, w + 1):          # query q = s + d, ascending
        s = slice(max(0, -d), min(N, N - d))
        q = slice(s.start + d, s.stop + d)
        hit = (adjacent(eta[:, q], phi[:, q], eta[:, s], phi[:, s], r2)[..., None]
               & (c[:, s] == m_safe[:, q]))
        dc[:, s] += torch.where(hit, g_safe[:, q], zero)
    return dc


def edgeconv_terms(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor]):
    """Split the linear edge MLP ``[x_i ‖ x_j − x_i] @ W + b`` into the
    per-target term ``a = x (W_self − W_diff) + b`` and the per-source term
    ``c = x W_diff`` (``weight`` is ``[2H, Hout]``, rows [self; diff])."""
    H = x.shape[-1]
    w_self, w_diff = weight[:H], weight[H:]
    c = torch.matmul(x, w_diff)
    a = torch.matmul(x, w_self - w_diff)
    if bias is not None:
        a = a + bias
    return a, c


def combine(a: torch.Tensor, m: torch.Tensor, mask: torch.Tensor):
    """``a + m`` where the node is real and has a neighbour, else 0 (the
    PyG empty-neighbourhood convention)."""
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
    """EdgeConv(linear MLP, max) over the implicit eta-sorted radius graph;
    equals the explicit uncapped radius graph whenever ``g.halo`` >=
    data/sorting.required_halo.  Only 'max' is ported."""
    if reduction != "max":
        raise NotImplementedError(
            f"window reduction {reduction!r} is not ported; only 'max'")
    a, c = edgeconv_terms(x, weight, bias)
    m = window_max_torch(c, g.etaphi, g.mask, float(g.r) ** 2, g.halo)
    return combine(a, m, g.mask)
