"""Implicit windowed EdgeConv in plain PyTorch (the JAX package's
``ops/window.py``).

For eta-sorted events every radius-graph neighbour of node i lies within
``halo`` index positions, so the EdgeConv-max aggregation over the
factorized message a_i + c_w (ops/edgeconv.py) is a masked window max:

    out_i = a_i + max_{w in [i-halo, i+halo], adj(i, w)} c_w

with adj(i, w) = (η_i−η_w)² + (φ_i−φ_w)² < r², no φ wrap (reference
train.py:47).  This module is the CPU path and the oracle of the CUDA
kernel (ops/cuda/edgeconv_window.py): both round the predicate the same
way, one IEEE operation at a time, and a max selects an input exactly, so
the two agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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

    Walks the offsets d = 0..halo once: the pair (i, i+d) is tested once
    and feeds both directions, since the predicate is symmetric."""
    B, N, H = c.shape
    eta, phi = pos[..., 0], pos[..., 1]
    neg = torch.tensor(float("-inf"), dtype=c.dtype, device=c.device)
    m = torch.full_like(c, float("-inf"))
    for d in range(min(halo, N - 1) + 1):
        lo, hi = slice(0, N - d), slice(d, N)
        adj = (adjacent(eta[:, hi], phi[:, hi], eta[:, lo], phi[:, lo], r2)
               & mask[:, hi] & mask[:, lo])[..., None]
        m_lo = m[:, lo]                       # queries i, sources i + d
        torch.maximum(m_lo, torch.where(adj, c[:, hi], neg), out=m_lo)
        if d:
            m_hi = m[:, hi]                   # queries i + d, sources i
            torch.maximum(m_hi, torch.where(adj, c[:, lo], neg), out=m_hi)
    return m


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
