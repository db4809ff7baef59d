"""The DRN's list matching (normalized-cut weights on the neighbour lists,
then the handshake rounds) as Hopper kernels (``csrc/cut_match.cu``).  It
replaces no TPU kernel: the JAX package's list matching is XLA ops.

``cut_match`` is the op.  It checks its inputs, then takes its plain
version (ops/coarsen.py: ``normalized_cut_weights``, then
``handshake_matching``) for CPU tensors of any shape and launches its
kernels for CUDA tensors; a CUDA tensor never reaches the plain version,
and one outside ``supported``, a failed build or a failed launch raises.
It counts its calls on the card.  ``_weights`` and ``_handshake``, its two
halves on checked CUDA tensors, are what the card's tests compare with
their plain versions.  The kernels sum in a fixed order, with no atomics:
the same bits from call to call and between an eager call and a replayed
CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops.coarsen import (handshake_matching,
                                             normalized_cut_weights)
from deepmetv2_tpu_torch.ops.cuda import build

# the kernels' range: 5 bytes a node of an event in shared memory (the
# handshake), the kNN kernels' largest cap, 16 features a lane (the
# weights' half-warp a row); the DRN cells run N=8192, cap=32, H=64
MAX_N = 32768
MAX_CAP = 128
MAX_H = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "cut_weights": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cut_handshake": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _fn(name: str):
    return build.function("cut_match", name, _ARGTYPES[name])


def supported(n: int, cap: int, h: int) -> bool:
    """Whether the kernels take ``N`` nodes, ``cap`` slots and ``H``
    features (every list-branch shape of the port: N up to the largest
    bucket, 8192, cap up to the kNN kernels' 128, H up to 256)."""
    return 1 <= n <= MAX_N and 1 <= cap <= MAX_CAP and 1 <= h <= MAX_H


def _check(nbr: Neighborhood, mask: torch.Tensor, h: torch.Tensor) -> None:
    """Raise on what the kernels do not take: ``nbr.idx`` int32 and
    ``nbr.mask`` bool ``[B, N, cap]``, ``mask`` bool ``[B, N]``, ``h``
    float32 ``[B, N, H]``, all on one device; off the CPU, within
    ``supported`` (the CPU's plain version takes any shape)."""
    if nbr.idx.dim() != 3 or h.dim() != 3:
        raise ValueError(f"cut_match: lists {tuple(nbr.idx.shape)} and h "
                         f"{tuple(h.shape)}, want [B, N, cap] and [B, N, H]")
    B, N, cap = nbr.idx.shape
    H = h.shape[-1]
    for what, t, shape in (("lists' mask", nbr.mask, (B, N, cap)),
                           ("h", h, (B, N, H)), ("node mask", mask, (B, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"cut_match: {what} {tuple(t.shape)}, want "
                             f"{shape}")
        if t.device != nbr.idx.device:
            raise ValueError(f"cut_match: {what} on {t.device}, lists on "
                             f"{nbr.idx.device}")
    if h.device.type != "cpu" and not supported(N, cap, H):
        raise ValueError(f"cut_match: N={N}, cap={cap}, H={H} outside "
                         f"1..{MAX_N}, 1..{MAX_CAP}, 1..{MAX_H}")
    if (nbr.idx.dtype != torch.int32 or nbr.mask.dtype != torch.bool
            or mask.dtype != torch.bool or h.dtype != torch.float32):
        raise TypeError(f"cut_match: want int32 lists, bool masks and "
                        f"float32 h, got {nbr.idx.dtype}, {nbr.mask.dtype}, "
                        f"{mask.dtype}, {h.dtype}")


def _weights(h: torch.Tensor, nbr: Neighborhood) -> torch.Tensor:
    """The weights' kernels on checked CUDA tensors: ``w [B, N, cap]``,
    ‖h_i − h_j‖₂·(1/deg_i + 1/deg_j) per listed edge, −inf at invalid
    slots (``normalized_cut_weights``)."""
    B, N, cap = nbr.idx.shape
    h, idx, nm = (t.contiguous() for t in (h, nbr.idx, nbr.mask))
    ivd = torch.empty((B, N), dtype=torch.float32, device=h.device)
    w = torch.empty((B, N, cap), dtype=torch.float32, device=h.device)
    build.launch(_fn("cut_weights"), h.device, h.data_ptr(), idx.data_ptr(),
                 nm.data_ptr(), ivd.data_ptr(), w.data_ptr(), B, N,
                 h.shape[-1], cap)
    return w


def _handshake(w: torch.Tensor, nbr: Neighborhood, mask: torch.Tensor,
               rounds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The handshake kernel on CUDA weights ``w [B, N, cap]`` float32 and
    checked lists: ``(cluster, partner)`` of ``rounds`` rounds
    (``handshake_matching``)."""
    B, N, cap = nbr.idx.shape
    w, idx, nm, mask = (t.contiguous() for t in (w, nbr.idx, nbr.mask, mask))
    cluster = torch.empty((B, N), dtype=torch.int64, device=w.device)
    partner = torch.empty_like(cluster)
    build.launch(_fn("cut_handshake"), w.device, w.data_ptr(),
                 idx.data_ptr(), nm.data_ptr(), mask.data_ptr(),
                 cluster.data_ptr(), partner.data_ptr(), B, N, cap,
                 int(rounds))
    return cluster, partner


def cut_match(h: torch.Tensor, nbr: Neighborhood, mask: torch.Tensor,
              rounds: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """The list matching of the post-conv features ``h [B, N, H]`` on
    ``nbr``'s lists: ``(cluster, partner)``, both ``[B, N]`` int64, as
    ``handshake_matching(normalized_cut_weights(h, nbr), nbr, mask)``
    gives them; on the card the weights pass through device memory
    once."""
    _check(nbr, mask, h)
    h = h.detach()
    if build.on_cpu("cut_match", h):
        return handshake_matching(normalized_cut_weights(h, nbr), nbr, mask,
                                  rounds=rounds)
    out = _handshake(_weights(h, nbr), nbr, mask, rounds)
    cut_match.launches += 1
    return out


build.counted(cut_match)
