"""GraphMET's three categorical embeddings as one op with Hopper kernels
for its forward and its backward (``csrc/cat_embed.cu``).  It replaces no
TPU kernel: the JAX package's lookups are XLA gathers.  The backward is
why it exists: torch's backward of ``w[idx]`` for 3-8 rows shared by
~10^5 candidates walks each row's duplicates one after another.

``cat_embed`` checks its inputs, then takes the plain composition
(ops/cat_embed.py:cat_embed_torch, autograd and all) for CPU tensors and
``CatEmbed`` for CUDA tensors: ``cat_embed_fwd`` and ``cat_embed_bwd``
launch the kernels there and count their launches; a CUDA tensor never
reaches a plain version, and a failed build or launch raises.  The
backward sums in a fixed order, with no atomics: the same bits from call
to call and between an eager call and a replayed CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from deepmetv2_tpu_torch.ops.cat_embed import (cat_embed_bwd_torch,
                                               cat_embed_torch)
from deepmetv2_tpu_torch.ops.cuda import build

MAX_D = 32       # H = 4D <= 128, the window kernels' MAX_H
MAX_ROWS = 8     # table rows the kernels hold per column

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "cat_embed_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P],
    "cat_embed_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P],
    "cat_embed_bwd_blocks": [_I, _I],
}


def _fn(name: str):
    return build.function("cat_embed", name, _ARGTYPES[name])


def _check(x_cat: torch.Tensor, D: int, pdg_rows: int, pdgs: Sequence[int],
           *tensors: torch.Tensor) -> None:
    """Raise on what the op does not take: x_cat [..., 3] int32, tables
    D wide with 1 <= D <= MAX_D, 1 <= len(pdgs) <= pdg_rows <= MAX_ROWS;
    x_cat and ``tensors`` contiguous and on one device."""
    if not 1 <= D <= MAX_D:
        raise ValueError(f"cat_embed: D={D} outside 1..{MAX_D}")
    if x_cat.dtype != torch.int32:
        raise TypeError(f"cat_embed: x_cat is {x_cat.dtype}, not int32")
    if x_cat.shape[-1] != 3:
        raise ValueError(f"cat_embed: x_cat {tuple(x_cat.shape)}, want "
                         "[..., 3]")
    if not 1 <= len(pdgs) <= pdg_rows <= MAX_ROWS:
        raise ValueError(f"cat_embed: {len(pdgs)} pdgIds for a table of "
                         f"{pdg_rows} rows; 1 <= ids <= rows <= {MAX_ROWS}")
    for t in (x_cat,) + tensors:
        if not t.is_contiguous():
            raise ValueError("cat_embed: inputs must be contiguous")
        if t.device != x_cat.device:
            raise ValueError(f"cat_embed: a tensor on {t.device}, x_cat on "
                             f"{x_cat.device}")


def _check_tables(x_cat: torch.Tensor, w_charge: torch.Tensor,
                  w_pdg: torch.Tensor, w_pv: torch.Tensor,
                  pdgs: Sequence[int]) -> int:
    """D, after ``_check`` and raising unless the tables are [3, D],
    [P, D], [8, D], float32 on a CUDA device."""
    D, tables = w_charge.shape[-1], (w_charge, w_pdg, w_pv)
    _check(x_cat, D, w_pdg.shape[0], pdgs, *tables)
    shapes = [tuple(w.shape) for w in tables]
    if shapes != [(3, D), (w_pdg.shape[0], D), (8, D)]:
        raise ValueError(f"cat_embed: tables {shapes}; want [3, D], [P, D], "
                         "[8, D]")
    if x_cat.device.type == "cuda" and any(w.dtype != torch.float32
                                           for w in tables):
        raise TypeError("cat_embed: the kernels take float32 tables")
    return D


def _pdgs(pdgs: Sequence[int]):
    return (ctypes.c_int * len(pdgs))(*pdgs), len(pdgs)


def cat_embed_fwd(x_cat: torch.Tensor, w_charge: torch.Tensor,
                  w_pdg: torch.Tensor, w_pv: torch.Tensor,
                  pdgs: Sequence[int]) -> torch.Tensor:
    """``[..., 3D]`` float32: each candidate's rows of the three tables,
    ``[charge | pdgId | fromPV]`` (ops/cat_embed.py:cat_embed_indices);
    not differentiable by itself (``CatEmbed`` is)."""
    D = _check_tables(x_cat, w_charge, w_pdg, w_pv, pdgs)
    if build.on_cpu("cat_embed_fwd", x_cat):
        return cat_embed_torch(x_cat, w_charge, w_pdg, w_pv, pdgs).detach()
    n = x_cat.numel() // 3
    out = torch.empty(x_cat.shape[:-1] + (3 * D,), dtype=torch.float32,
                      device=x_cat.device)
    ids, n_ids = _pdgs(pdgs)
    build.launch(_fn("cat_embed_fwd"), x_cat.device, x_cat.data_ptr(),
                 w_charge.data_ptr(), w_pdg.data_ptr(), w_pv.data_ptr(),
                 out.data_ptr(), n, D, w_pdg.shape[0], ids, n_ids)
    cat_embed_fwd.launches += 1
    return out


build.counted(cat_embed_fwd)


def cat_embed_bwd(x_cat: torch.Tensor, g: torch.Tensor, pdg_rows: int,
                  pdgs: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tables' gradients ``[3, D]``, ``[pdg_rows, D]``, ``[8, D]`` from
    ``g [..., 3D]`` (float32), the gradient of ``cat_embed_fwd``'s output:
    each row's sum over every candidate that picks it, padded ones
    included, in a fixed order (two passes, no atomics)."""
    D = g.shape[-1] // 3
    if (g.dtype != torch.float32 or g.shape[:-1] != x_cat.shape[:-1]
            or g.shape[-1] != 3 * D or g.device != x_cat.device):
        raise ValueError(f"cat_embed_bwd: g {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} does not match x_cat "
                         f"{tuple(x_cat.shape)}: want float32 [..., 3D]")
    _check(x_cat, D, pdg_rows, pdgs)
    if build.on_cpu("cat_embed_bwd", x_cat):
        return cat_embed_bwd_torch(x_cat, g, pdg_rows, pdgs)
    g = g.contiguous()
    tables = [torch.empty((rows, D), dtype=torch.float32, device=g.device)
              for rows in (3, pdg_rows, 8)]
    n = x_cat.numel() // 3
    blocks = _fn("cat_embed_bwd_blocks")(n, D)
    part = torch.empty((blocks, (11 + pdg_rows) * D), dtype=torch.float32,
                       device=g.device)
    ids, n_ids = _pdgs(pdgs)
    build.launch(_fn("cat_embed_bwd"), g.device, x_cat.data_ptr(),
                 g.data_ptr(), part.data_ptr(),
                 *(t.data_ptr() for t in tables), n, D, pdg_rows, ids, n_ids)
    cat_embed_bwd.launches += 1
    return tuple(tables)


build.counted(cat_embed_bwd)


class CatEmbed(torch.autograd.Function):
    """``cat_embed_fwd`` with ``cat_embed_bwd`` as its backward; only
    ``x_cat`` is saved (the backward recomputes the indices), and x_cat and
    pdgs get no gradient."""

    @staticmethod
    def forward(ctx, x_cat, w_charge, w_pdg, w_pv, pdgs):
        ctx.save_for_backward(x_cat)
        ctx.pdg_rows, ctx.pdgs = w_pdg.shape[0], pdgs
        return cat_embed_fwd(x_cat, w_charge, w_pdg, w_pv, pdgs)

    @staticmethod
    def backward(ctx, g):
        x_cat, = ctx.saved_tensors
        return (None, *cat_embed_bwd(x_cat, g, ctx.pdg_rows, ctx.pdgs), None)


def cat_embed(x_cat: torch.Tensor, w_charge: torch.Tensor,
              w_pdg: torch.Tensor, w_pv: torch.Tensor,
              pdgs: Sequence[int]) -> torch.Tensor:
    """``[..., 3D]`` float32, each candidate's rows of the charge, pdgId
    and fromPV tables (ops/cat_embed.py), differentiable in the tables:
    the plain composition on the CPU, ``CatEmbed`` on the card."""
    if build.on_cpu("cat_embed", x_cat):
        _check_tables(x_cat, w_charge, w_pdg, w_pv, pdgs)
        return cat_embed_torch(x_cat, w_charge, w_pdg, w_pv, pdgs)
    return CatEmbed.apply(x_cat, w_charge, w_pdg, w_pv, tuple(pdgs))
