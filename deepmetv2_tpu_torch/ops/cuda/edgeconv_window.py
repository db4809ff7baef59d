"""Windowed EdgeConv with the aggregation and its gradient as Hopper
kernels (``csrc/window_max.cu``), the counterpart of the JAX package's
``ops/pallas/edgeconv_window.py``, and the double-buffered variant of the
forward that ``scripts/window_revolver_probe.py`` measured on the TPU
(``window_max_pipelined``; no path calls it but the probe module
``deepmetv2_tpu_torch/probes/window_revolver.py``).

``window_max``, ``window_max_pipelined`` and ``window_max_bwd`` launch
their kernels for a CUDA tensor and take the plain versions (ops/window.py:
``window_max_torch``, ``window_max_bwd_torch``) for a CPU tensor; a CUDA
tensor never reaches a plain version, and a failed build or launch
raises.  ``window_max`` and ``window_max_bwd`` take float32 or bfloat16
values (the coordinates stay float32): bfloat16 launches the kernels'
bf16 instantiations, whose launches are counted apart, under
``window_max_bf16`` and ``window_max_bwd_bf16`` (which take bfloat16
only).  ``WindowMax`` is the ``torch.autograd.Function`` that pairs the
forward and the backward, with the TPU kernel's tie rule (every tied
source gets the full gradient).  The GEMMs stay ``torch.matmul``, as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.ops.window import (PAD_POS, WindowGraph, combine,
                                            edgeconv_terms, padded_pos,
                                            padded_rows, window_max_bwd_torch,
                                            window_max_torch)

MAX_H = 128     # the kernels keep ceil(H/32) <= 4 features per lane

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "window_max_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "window_max_fwd_pipelined": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "window_max_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "window_max_fwd_bf16": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "window_max_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}
_VALUE_TYPES = (torch.float32, torch.bfloat16)


def _launch(name: str, c: torch.Tensor, *args) -> None:
    build.launch(build.function("window_max", name, _ARGTYPES[name]),
                 c.device, *args)


def _check(name: str, c: torch.Tensor, pos: torch.Tensor,
           *others: torch.Tensor) -> None:
    """Raise on what the kernels do not take: c [B, N, H] float32 or
    bfloat16 with 0 < H <= MAX_H; pos [B, N, 2] float32; further [B, N, H]
    tensors of c's type; all on c's device."""
    B, N, H = c.shape
    if not (0 < H <= MAX_H):
        raise ValueError(f"{name}: H={H} outside 1..{MAX_H}")
    if c.dtype not in _VALUE_TYPES or pos.dtype != torch.float32 or any(
            t.dtype != c.dtype for t in others):
        raise TypeError(f"{name}: values must be one type, float32 or "
                        f"bfloat16, and pos float32; got c {c.dtype}, pos "
                        f"{pos.dtype}, others {[t.dtype for t in others]}")
    for t, shape in zip((pos,) + others, [(B, N, 2)] + [(B, N, H)] * 2):
        if tuple(t.shape) != shape or t.device != c.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device} does "
                             f"not match c {tuple(c.shape)} on {c.device}")


def _pos(pos: torch.Tensor) -> torch.Tensor:
    """``pos`` contiguous and 8-byte aligned: the kernels read its rows as
    float2, so a view at an odd float offset is copied."""
    pos = pos.detach().contiguous()
    return pos if pos.data_ptr() % 8 == 0 else pos.clone()


def _fwd(entry: str, c: torch.Tensor, pos: torch.Tensor, r2: float,
         halo: int) -> torch.Tensor:
    B, N, H = c.shape
    c, pos = c.detach().contiguous(), _pos(pos)
    out = torch.empty_like(c)
    _launch(entry, c, c.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, N, H, int(halo), float(r2))
    return out


def window_max(c: torch.Tensor, pos: torch.Tensor, r2: float,
               halo: int) -> torch.Tensor:
    """``m[b,i,:] = max c[b,w,:]`` over w in [i−halo, i+halo] ∩ [0, N) with
    ``(η_i−η_w)² + (φ_i−φ_w)² < r2``; −inf where there is none.  ``pos`` is
    ``[B, N, 2]`` with padded rows at ``PAD_POS`` (any eta >= ``PAD_POS / 2``
    marks a row padded, ``padded_rows``): a padded query row gets −inf and
    a padded source is never selected.  ``m`` has c's type; bfloat16
    values launch the bf16 instantiation, counted in ``window_max_bf16``'s
    ``launches``.  Not differentiable by itself: ``WindowMax`` is."""
    if build.on_cpu("window_max", c):
        return window_max_torch(c, pos, ~padded_rows(pos), r2, halo)
    _check("window_max", c, pos)
    if c.dtype == torch.bfloat16:
        out = _fwd("window_max_fwd_bf16", c, pos, r2, halo)
        window_max_bf16.launches += 1
        return out
    out = _fwd("window_max_fwd", c, pos, r2, halo)
    window_max.launches += 1
    return out


build.counted(window_max)


def window_max_bf16(c: torch.Tensor, pos: torch.Tensor, r2: float,
                    halo: int) -> torch.Tensor:
    """``window_max`` on bfloat16 values only; ``launches`` counts the bf16
    instantiation's launches (``window_max_fwd_bf16``), by whichever of the
    two they were asked for."""
    if c.dtype != torch.bfloat16:
        raise TypeError(f"window_max_bf16: c is {c.dtype}, not bfloat16")
    return window_max(c, pos, r2, halo)


build.counted(window_max_bf16)


def window_max_pipelined(c: torch.Tensor, pos: torch.Tensor, r2: float,
                         halo: int) -> torch.Tensor:
    """``window_max`` by the kernel that stages its window chunks through a
    two-stage cp.async double buffer (csrc/window_max.cu); the same
    function, bit for bit."""
    if build.on_cpu("window_max_pipelined", c):
        return window_max_torch(c, pos, ~padded_rows(pos), r2, halo)
    _check("window_max_pipelined", c, pos)
    if c.dtype != torch.float32:
        raise TypeError(f"window_max_pipelined: c is {c.dtype}, not float32")
    out = _fwd("window_max_fwd_pipelined", c, pos, r2, halo)
    window_max_pipelined.launches += 1
    return out


build.counted(window_max_pipelined)


def _bwd(entry: str, c: torch.Tensor, pos: torch.Tensor, m: torch.Tensor,
         g: torch.Tensor, r2: float, halo: int) -> torch.Tensor:
    B, N, H = c.shape
    c, m, g = (t.detach().contiguous() for t in (c, m, g))
    pos = _pos(pos)
    dc = torch.empty_like(c)
    _launch(entry, c, c.data_ptr(), pos.data_ptr(), m.data_ptr(),
            g.data_ptr(), dc.data_ptr(), B, N, H, int(halo), float(r2))
    return dc


def window_max_bwd(c: torch.Tensor, pos: torch.Tensor, m: torch.Tensor,
                   g: torch.Tensor, r2: float, halo: int) -> torch.Tensor:
    """Gradient of ``window_max`` with respect to c (see
    ops/window.py:window_max_bwd_torch): every adjacent source whose value
    equals its query's max gets that query's full gradient; 0 at a padded
    source, and a padded query contributes nothing.  c, m, g and dc are of
    one type; bfloat16 launches the bf16 instantiation, counted in
    ``window_max_bwd_bf16``'s ``launches``."""
    if build.on_cpu("window_max_bwd", c):
        return window_max_bwd_torch(c, pos, m, g, r2, halo)
    _check("window_max_bwd", c, pos, m, g)
    if c.dtype == torch.bfloat16:
        dc = _bwd("window_max_bwd_bf16", c, pos, m, g, r2, halo)
        window_max_bwd_bf16.launches += 1
        return dc
    dc = _bwd("window_max_bwd", c, pos, m, g, r2, halo)
    window_max_bwd.launches += 1
    return dc


build.counted(window_max_bwd)


def window_max_bwd_bf16(c: torch.Tensor, pos: torch.Tensor, m: torch.Tensor,
                        g: torch.Tensor, r2: float, halo: int) -> torch.Tensor:
    """``window_max_bwd`` on bfloat16 values only (each source's terms
    summed in float32 in ascending query order, ``dc`` rounded to bfloat16
    once); ``launches`` counts the bf16 instantiation's launches
    (``window_max_bwd_bf16``), by whichever of the two they were asked
    for."""
    if c.dtype != torch.bfloat16:
        raise TypeError(f"window_max_bwd_bf16: c is {c.dtype}, not bfloat16")
    return window_max_bwd(c, pos, m, g, r2, halo)


build.counted(window_max_bwd_bf16)


class WindowMax(torch.autograd.Function):
    """``window_max`` with ``window_max_bwd`` as its backward; ``pos``
    gets no gradient."""

    @staticmethod
    def forward(ctx, c, pos, r2: float, halo: int):
        m = window_max(c, pos, r2, halo)
        ctx.save_for_backward(c, pos, m)
        ctx.r2, ctx.halo = r2, halo
        return m

    @staticmethod
    def backward(ctx, g):
        c, pos, m = ctx.saved_tensors
        return window_max_bwd(c, pos, m, g, ctx.r2, ctx.halo), None, None, None


def window_edgeconv_linear_cuda(
    x: torch.Tensor,           # [B, N, H]
    g: WindowGraph,
    weight: torch.Tensor,      # [2H, Hout] rows [self; diff]
    bias: Optional[torch.Tensor],
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """EdgeConv(linear MLP, max) over the implicit radius graph with the
    aggregation through ``WindowMax`` (the kernels on a CUDA tensor, their
    plain versions on a CPU tensor); the counterpart of
    ``window_edgeconv_linear_pallas``, ``dtype`` included (bfloat16: see
    ops/window.py:edgeconv_terms; the max runs on bf16 values).  float32
    out; 0 and no gradient at padded nodes."""
    a, c = edgeconv_terms(x, weight, bias, dtype)
    m = WindowMax.apply(c, padded_pos(g.etaphi, g.mask), float(g.r) ** 2,
                        g.halo)
    return combine(a, m, g.mask)
