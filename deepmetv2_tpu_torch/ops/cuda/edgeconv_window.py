"""Windowed EdgeConv with the aggregation as a Hopper kernel
(``csrc/window_max.cu``), the counterpart of the JAX package's
``ops/pallas/edgeconv_window.py``.

``window_max`` launches the kernel for a CUDA tensor and takes the plain
version (ops/window.py:window_max_torch) for a CPU tensor.  The GEMMs stay
``torch.matmul``, as the JAX package leaves them to XLA.  Forward only:
the backward kernel and its ``torch.autograd.Function`` come with the
training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepmetv2_tpu_torch.ops.window import (WindowGraph, combine,
                                            edgeconv_terms, window_max_torch)

PAD_POS = 1e9   # coordinate of padded rows: never adjacent to a real row
MAX_H = 128     # the kernel keeps ceil(H/32) <= 4 features per lane

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from deepmetv2_tpu_torch.ops.cuda import build

        fn = build.load("window_max").window_max_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def window_max(c: torch.Tensor, pos: torch.Tensor, r2: float,
               halo: int) -> torch.Tensor:
    """``m[b,i,:] = max c[b,w,:]`` over w in [i−halo, i+halo] ∩ [0, N) with
    ``(η_i−η_w)² + (φ_i−φ_w)² < r2``; −inf where there is none.  ``pos`` is
    ``[B, N, 2]`` with padded rows at ``PAD_POS`` (padded rows are adjacent
    to each other, at distance 0; the caller masks them)."""
    if c.device.type == "cpu":
        return window_max_torch(c, pos, torch.ones(c.shape[:2], dtype=torch.bool),
                                r2, halo)
    if c.device.type != "cuda":
        raise ValueError(f"window_max: unsupported device {c.device}")
    if c.requires_grad or pos.requires_grad:
        raise NotImplementedError(
            "window_max on CUDA is forward-only in this slice; its backward "
            "kernel comes with the training slice (run under torch.no_grad())")
    B, N, H = c.shape
    if c.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError("window_max: c and pos must be float32")
    if pos.shape != (B, N, 2) or pos.device != c.device:
        raise ValueError(f"window_max: pos {tuple(pos.shape)} on {pos.device} "
                         f"does not match c {tuple(c.shape)} on {c.device}")
    if not (0 < H <= MAX_H):
        raise ValueError(f"window_max: H={H} outside 1..{MAX_H}")
    c = c.contiguous()
    pos = pos.contiguous()
    out = torch.empty_like(c)
    with torch.cuda.device(c.device):
        err = _kernel()(c.data_ptr(), pos.data_ptr(), out.data_ptr(), B, N, H,
                        int(halo), float(r2),
                        torch.cuda.current_stream(c.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_max_fwd launch failed: cudaError {err}")
    window_max.launches += 1
    return out


window_max.launches = 0


def window_edgeconv_linear_cuda(
    x: torch.Tensor,           # [B, N, H]
    g: WindowGraph,
    weight: torch.Tensor,      # [2H, Hout] rows [self; diff]
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """EdgeConv(linear MLP, max) over the implicit radius graph with the
    aggregation in the kernel; the counterpart of
    ``window_edgeconv_linear_pallas``.  0 at padded nodes."""
    a, c = edgeconv_terms(x, weight, bias)
    pos = torch.where(g.mask[..., None], g.etaphi,
                      torch.full_like(g.etaphi, PAD_POS))
    m = window_max(c, pos, float(g.r) ** 2, g.halo)
    return combine(a, m, g.mask)
