"""The fused undirected kNN graph build with its two passes as Hopper
kernels (``csrc/knn_und.cu``), the counterpart of the JAX package's
``ops/pallas/knn_und.py:knn_und_graph``.

``knn_kth`` and ``knn_extract`` launch their kernels for a CUDA tensor and
take the plain versions (ops/knn_und.py) for a CPU tensor; a CUDA tensor
never reaches a plain version, and a failed build or launch raises.  The
graph carries no gradient: the inputs are detached.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.ops.knn_und import (knn_extract_torch,
                                             knn_kth_torch, neighborhood,
                                             supported)

# widest h the kernels take: 8 query rows and two 64-row chunks of sources,
# all H wide, fit in shared memory beside 64 KB of d² rows (at N <= 8192;
# a shape past the card's shared memory is refused at launch and raises)
MAX_H = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "knn_kth": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "knn_extract": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _I, _P],
}


def _scratch(B: int, N: int, device):
    """The compaction's scratch: ``perm [B, N]`` (each event's valid ids
    ascending, then its padded ids) and ``cnt [B]``, both int32."""
    return (torch.empty((B, N), dtype=torch.int32, device=device),
            torch.empty((B,), dtype=torch.int32, device=device))


def _prepare(name: str, h: torch.Tensor, mask: torch.Tensor, *others):
    """Contiguous f32 ``h [B, N, H]`` with 0 < H <= MAX_H and a bool mask
    ``[B, N]``, plus further ``[B, N]`` f32 tensors, all on h's device."""
    B, N, H = h.shape
    if not 0 < H <= MAX_H:
        raise ValueError(f"{name}: H={H} outside 1..{MAX_H}")
    if h.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"{name}: h must be float32 and mask bool")
    for t in (mask,) + others:
        if tuple(t.shape) != (B, N) or t.device != h.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device} does "
                             f"not match h {tuple(h.shape)} on {h.device}")
    return [t.detach().contiguous() for t in (h, mask) + others]


def knn_kth(h: torch.Tensor, mask: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(t, sq)``: each node's k-th smallest masked squared distance ``t
    [B, N]`` and the squared norms ``sq [B, N]`` that ``knn_extract`` takes
    (see ops/knn_und.py)."""
    if build.on_cpu("knn_kth", h):
        return knn_kth_torch(h, mask, k)
    h, mask = _prepare("knn_kth", h, mask)
    B, N, H = h.shape
    if not 1 <= k <= N:
        raise ValueError(f"knn_kth: k={k} outside 1..N={N}")
    sq = torch.empty((B, N), dtype=torch.float32, device=h.device)
    t = torch.empty_like(sq)
    perm, cnt = _scratch(B, N, h.device)
    build.launch(build.function("knn_und", "knn_kth", _ARGTYPES["knn_kth"]),
                 h.device, h.data_ptr(), mask.data_ptr(), sq.data_ptr(),
                 t.data_ptr(), perm.data_ptr(), cnt.data_ptr(), B, N, H,
                 int(k))
    knn_kth.launches += 1
    return t, sq


build.counted(knn_kth)


def knn_extract(h: torch.Tensor, mask: torch.Tensor, t: torch.Tensor,
                sq: torch.Tensor, cap: int, want_rel: bool = False,
                directed: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
    """``(idx, d2v, rel)``: the threshold relation's first ``cap`` members
    per row in ascending (d², index) order, and the relation itself as a
    bool ``[B, N, N]`` when ``want_rel`` (else None), from ``knn_kth``'s
    ``(t, sq)``; ``directed``: the relation ``d² <= t_i`` alone (see
    ops/knn_und.py:knn_extract_torch)."""
    if build.on_cpu("knn_extract", h):
        return knn_extract_torch(h, mask, t, sq, cap, want_rel, directed)
    h, mask, t, sq = _prepare("knn_extract", h, mask, t, sq)
    B, N, H = h.shape
    if not 1 <= cap:
        raise ValueError(f"knn_extract: cap={cap} must be positive")
    dev = h.device
    idx = torch.empty((B, N, cap), dtype=torch.int32, device=dev)
    d2v = torch.empty((B, N, cap), dtype=torch.float32, device=dev)
    rel = (torch.empty((B, N, N), dtype=torch.bool, device=dev)
           if want_rel else None)
    perm, cnt = _scratch(B, N, dev)
    build.launch(build.function("knn_und", "knn_extract",
                                _ARGTYPES["knn_extract"]),
                 dev, h.data_ptr(), mask.data_ptr(), t.data_ptr(),
                 sq.data_ptr(), idx.data_ptr(), d2v.data_ptr(),
                 rel.data_ptr() if want_rel else None, perm.data_ptr(),
                 cnt.data_ptr(), B, N, H, int(cap), int(directed))
    knn_extract.launches += 1
    return idx, d2v, rel


build.counted(knn_extract)


def knn_und_graph(h: torch.Tensor, mask: torch.Tensor, k: int = 16,
                  cap: int = 32, want_rel: bool = False):
    """Fused equivalent of ``to_undirected(knn_graph(h, mask, k))`` (the
    JAX ``knn_und_graph`` with ``sort_ids=False``): ``(nbr, d2v, t)``, and
    ``rel`` last with ``want_rel``.  Slots are in ascending-d² order; a row
    past the cap keeps its nearest ``cap`` neighbours."""
    B, N, _ = h.shape
    if not supported(N, cap):
        raise ValueError(f"knn_und_graph: unsupported shape N={N} cap={cap}")
    t, sq = knn_kth(h, mask, k)
    idx, d2v, rel = knn_extract(h, mask, t, sq, cap, want_rel)
    nbr, d2v = neighborhood(idx, d2v, mask)
    if want_rel:
        return nbr, d2v, t, rel
    return nbr, d2v, t
