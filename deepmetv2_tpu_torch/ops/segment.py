"""Neighbour gathers over padded batches (the JAX package's
``ops/segment.py``: ``gather_neighbors``, ``_batched_take`` and the mirror
table ``mirror_slots_sorted``, which ``build_dyn_graph(want_mirror=True)``
uses to keep only the edges listed both ways)."""

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


def mirror_slots_sorted(nbr: Neighborhood):
    """Per-slot mirror slots of a neighbour list (the JAX package's
    ``ops/segment.py:mirror_slots_sorted``): ``mirror[b, i, s]`` is the slot
    s' with ``idx[b, idx[b, i, s], s'] == i``, the same undirected edge seen
    from the other end.  Returns ``(mirror, found)``; ``found`` marks the
    valid slots whose reverse edge is listed (on a symmetric list, ``found
    == mask``), and ``mirror`` is 0 elsewhere.  Each directed slot i -> j
    is the key i·N + j; the keys are sorted once and each slot's reversed
    key j·N + i is looked up by binary search.  A node's valid slots must
    list each neighbour at most once (every list the port builds does)."""
    idx, mask = nbr.idx, nbr.mask
    B, N, K = idx.shape
    # sentinel keys reach about 2·N² + 2·N·K: keep them in int32's range,
    # as the JAX package does
    if 2 * N * N + 2 * N * K >= 2**31:
        raise ValueError(
            f"mirror_slots_sorted: N={N} overflows the int32 key encoding "
            f"(needs 2N²+2NK < 2³¹)")
    dev = idx.device
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.arange(N, **i32)[None, :, None].expand(B, N, K)
    E = N * K
    big = N * N
    sent = big + torch.arange(E, **i32).reshape(1, N, K)
    key_fwd = torch.where(mask, rows * N + idx, sent).reshape(B, E)
    key_rev = torch.where(mask, idx * N + rows, big + E + sent).reshape(B, E)
    sorted_fwd, order = torch.sort(key_fwd, dim=-1)
    pos = torch.searchsorted(sorted_fwd, key_rev.contiguous())
    pos = torch.clamp(pos, max=E - 1)
    hit_key = torch.gather(sorted_fwd, 1, pos)
    found = (hit_key == key_rev).reshape(B, N, K) & mask
    mirror = (torch.gather(order, 1, pos).reshape(B, N, K) % K).to(torch.int32)
    return torch.where(found, mirror, torch.zeros_like(mirror)), found
