"""Masked reductions and neighbour gathers over padded batches (the JAX
package's ``ops/segment.py``; reference model/net.py:55-56 and the 'max'
aggregation of PyG EdgeConv, model/graph_met_network.py:38).

With the padded layout a reduction over an event is a masked reduction
over the node axis, and a node's neighbourhood reduction a masked
reduction over the K axis of a gather.  Maxima use ``torch.amax``, whose
gradient splits evenly among tied entries as ``jnp.max``'s does
(``torch.max(dim)`` sends it all to one index).
"""

from __future__ import annotations

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood

_NEG_INF = float("-inf")


def _expand(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``mask`` with trailing unit axes up to ``x``'s rank."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - mask.ndim))


def masked_sum(x: torch.Tensor, mask: torch.Tensor, axis: int = 1
               ) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` counting only masked-true entries (the
    per-event ``scatter_add(values, batch)``): ``x [B, N, ...]``, ``mask
    [B, N]``."""
    m = _expand(mask, x)
    return torch.where(m, x, torch.zeros_like(x)).sum(dim=axis)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int = 1,
                eps: float = 0.0) -> torch.Tensor:
    """Mean over the masked-true entries; the count is floored at 1 (at
    ``eps`` when it is given)."""
    m = _expand(mask, x)
    total = torch.where(m, x, torch.zeros_like(x)).sum(dim=axis)
    count = m.sum(dim=axis)
    return total / torch.clamp(count, min=1 if eps == 0.0 else eps)


def masked_max(x: torch.Tensor, mask: torch.Tensor, axis: int = 1,
               empty_value: float = 0.0) -> torch.Tensor:
    """Max over the masked-true entries; a segment without one gives
    ``empty_value`` (0, torch_scatter's fill for an empty segment)."""
    m = _expand(mask, x)
    mx = torch.amax(torch.where(m, x, torch.full_like(x, _NEG_INF)),
                    dim=axis)
    return torch.where(m.any(dim=axis), mx, torch.full_like(mx, empty_value))


def masked_softmax(x: torch.Tensor, mask: torch.Tensor, axis: int = -1
                   ) -> torch.Tensor:
    """Softmax over the masked-true entries of ``axis``; masked entries
    and fully masked rows give 0."""
    m = _expand(mask, x)
    z = torch.where(m, x, torch.full_like(x, _NEG_INF))
    z = z - torch.amax(z, dim=axis, keepdim=True).detach()
    e = torch.where(m, torch.exp(z), torch.zeros_like(z))
    return e / torch.clamp(e.sum(dim=axis, keepdim=True), min=1e-30)


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


def neighbor_reduce(values: torch.Tensor, nbr: Neighborhood,
                    reduction: str = "max", empty_value: float = 0.0
                    ) -> torch.Tensor:
    """Gather and masked reduce over each node's list: ``out[b, i] =
    reduce_{k valid} values[b, idx[b, i, k]]`` for 'sum', 'mean', 'max' or
    'min'; a node without a valid slot gives ``empty_value`` under max and
    min, 0 under sum and mean."""
    g = gather_neighbors(values, nbr)                 # [B, N, K, H]
    m = nbr.mask[..., None]
    if reduction in ("sum", "mean"):
        s = torch.where(m, g, torch.zeros_like(g)).sum(dim=2)
        if reduction == "sum":
            return s
        return s / torch.clamp(m.sum(dim=2), min=1)
    if reduction in ("max", "min"):
        fill = _NEG_INF if reduction == "max" else float("inf")
        red = torch.amax if reduction == "max" else torch.amin
        r = red(torch.where(m, g, torch.full_like(g, fill)), dim=2)
        return torch.where(m.any(dim=2), r, torch.full_like(r, empty_value))
    raise ValueError(f"unknown reduction {reduction!r}")


def mirror_slots(nbr: Neighborhood):
    """Per-slot mirror slots by comparing rows (O(E·K)): ``mirror[b, i,
    s]`` is the first slot s' with ``idx[b, idx[b, i, s], s'] == i``, the
    same undirected edge seen from the other end.  Returns ``(mirror,
    found)``; ``found`` marks the valid slots whose reverse edge is listed
    (on a symmetric list, ``found == mask``).  ``mirror_slots_sorted`` is
    the O(E log E) form of the same table."""
    idx, mask = nbr.idx, nbr.mask
    N = idx.shape[1]
    rows = batched_take(idx, idx)                     # [B, N, K, K]
    rowm = batched_take(mask, idx)
    i_ids = torch.arange(N, device=idx.device,
                         dtype=idx.dtype)[None, :, None, None]
    hit = (rows == i_ids) & rowm & mask[..., None]
    found = hit.any(dim=-1)
    mirror = torch.argmax(hit.to(torch.uint8), dim=-1).to(torch.int32)
    return mirror, found


class _GatherMirror(torch.autograd.Function):
    """``where(mask, values[idx], 0)`` whose backward is a gather through
    the mirror table: ``dvalues[b, j] = Σ_s valid ct[b, idx[b, j, s],
    mirror[b, j, s]]``, the cotangents of the edges into j read from the
    other end (JAX ``ops/segment.py:_gather_mirror``)."""

    @staticmethod
    def forward(ctx, values, idx, mask, mirror):
        ctx.save_for_backward(idx, mask, mirror)
        g = batched_take(values, idx)
        return torch.where(_expand(mask, g), g, torch.zeros_like(g))

    @staticmethod
    def backward(ctx, ct):
        idx, mask, mirror = ctx.saved_tensors
        B, N, K = idx.shape
        flat = ct.reshape((B, N * K) + tuple(ct.shape[3:]))
        fidx = (idx.to(torch.int64) * K + mirror).reshape(B, N * K)
        picked = batched_take(flat, fidx).reshape(ct.shape)
        dv = torch.where(_expand(mask, picked), picked,
                         torch.zeros_like(picked)).sum(dim=2)
        return dv, None, None, None


def gather_neighbors_mirror(values: torch.Tensor, nbr: Neighborhood,
                            mirror: torch.Tensor) -> torch.Tensor:
    """Masked neighbour gather (invalid slots read 0) whose backward is a
    gather too, through ``mirror`` (``mirror_slots`` or
    ``mirror_slots_sorted``), never a scatter.  ``nbr`` must be symmetric
    with ``mirror`` its table (``found == mask``): every valid edge listed
    at both ends, as ``to_undirected`` and ``build_dyn_graph(want_mirror=
    True)`` give it.  Then forward and backward equal those of
    ``where(mask, gather_neighbors(values, nbr), 0)``, the backward's sums
    taken per node in slot order."""
    return _GatherMirror.apply(values, nbr.idx, nbr.mask, mirror)


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
