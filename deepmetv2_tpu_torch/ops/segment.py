"""Neighbour gathers over padded batches (the JAX package's
``ops/segment.py``: ``gather_neighbors`` and ``_batched_take``).  The
mirror gather (``mirror_gather``) is not ported yet."""

from __future__ import annotations

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood


def batched_take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ...] = values[b, idx[b, ...]]`` for ``values [B, N, ...]``
    and integer ``idx [B, ...]``, through one take on the batch-collapsed
    ``[B·N, ...]`` table."""
    B, N = values.shape[:2]
    flat = values.reshape((B * N,) + tuple(values.shape[2:]))
    off = torch.arange(B, device=idx.device, dtype=torch.int64).reshape(
        (B,) + (1,) * (idx.ndim - 1)) * N
    rows = (idx.to(torch.int64) + off).reshape(-1)
    return flat[rows].reshape(tuple(idx.shape) + tuple(values.shape[2:]))


def gather_neighbors(values: torch.Tensor, nbr: Neighborhood) -> torch.Tensor:
    """Neighbour features ``values [B, N, H]`` → ``[B, N, K, H]`` (invalid
    slots read row 0)."""
    return batched_take(values, nbr.idx)
