"""Collectives with written-out backwards, for the mesh steps.

* ``all_reduce_sum``: the sum over a group; its adjoint is the sum over
  the same group of the cotangents (each rank's output feeds every rank's
  loss).
* ``HaloExchange``: the ring exchange of the JAX package's
  ``parallel/halo.py:_edge_exchange``.  Every rank of a node group sends
  its first and last ``h`` rows, fused as ``[c ‖ pos]`` in one message,
  and receives the right edge of its left neighbour (``from_left``) and
  the left edge of its right neighbour (``from_right``); the ring ends are
  filled with 0 for c and ``PAD_POS`` for pos, so no phantom row is
  adjacent.  Its backward sends the gradient of each received strip back
  to its owner, which adds it to its own edge rows; the fill gets no
  gradient.  The exchange is an all-gather of the edge strips inside the
  node group, posted asynchronously (``PendingExchange``) so that a
  caller can run local work before it waits.
* ``gather_rows``: the all-gather of evaluation outputs, no gradient.
* ``gather_nodes``: the all-gather of a node shard over its node group
  (the node-sharded DRN, parallel/dyn.py): every rank gets the whole
  padded node axis; its backward is the reduce-scatter, each rank's
  cotangent of the whole axis summed over the group and this rank's rows
  kept (an all-reduce, then a slice).
* ``ring_shift``: the node group's ring rotation (the JAX ``ppermute`` to
  ``(n + 1) mod N``): each rank sends its tensor to the next rank and
  receives the previous rank's, no gradient.

Every rank of a group must call the same collectives in the same order;
the backwards run in the order autograd visits the (identical) graphs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from deepmetv2_tpu_torch.ops.window import PAD_POS


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return mesh.all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.group), None, None


def all_reduce_sum(t: torch.Tensor, mesh, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (None: every rank), differentiable:
    the gradient of each rank's input is the sum of the gradients of every
    rank's output."""
    return _AllReduceSum.apply(t, mesh, group)


def gather_rows(t: torch.Tensor, mesh, group) -> torch.Tensor:
    """``t`` of every rank of ``group`` concatenated along the first axis
    in the group's rank order (no gradient)."""
    return torch.cat(mesh.all_gather(t.detach(), group), dim=0)


class PendingExchange:
    """The exchange of the ``h``-row edge strips of ``[c ‖ pos]`` inside
    this rank's node group, posted at construction; ``wait()`` returns
    ``(from_left, from_right)``, each ``[B, h, H + 2]``."""

    def __init__(self, c: torch.Tensor, pos: torch.Tensor, h: int, mesh):
        self.h, self.mesh, self.device = h, mesh, c.device
        self.H = c.shape[-1]
        payload = torch.cat([c.detach(), pos.detach().to(c.dtype)], dim=-1)
        B, _, F = payload.shape
        fill = torch.cat([torch.zeros(self.H, dtype=c.dtype, device=c.device),
                          torch.full((2,), PAD_POS, dtype=c.dtype,
                                     device=c.device)])
        self.fill = fill.expand(B, h, F)
        self.work = None
        if mesh.n_node == 1:
            return
        edges = torch.cat([payload[:, :h], payload[:, -h:]], dim=1)
        if mesh.staged:
            edges = edges.cpu()
        self.parts = [torch.empty_like(edges) for _ in range(mesh.n_node)]
        self.work = dist.all_gather(self.parts, edges.contiguous(),
                                    group=mesh.node_group, async_op=True)

    def wait(self):
        n, h, mesh = self.mesh.node_index, self.h, self.mesh
        if self.work is None:
            return self.fill, self.fill
        self.work.wait()
        left = (self.parts[n - 1][:, h:].to(self.device) if n > 0
                else self.fill)
        right = (self.parts[n + 1][:, :h].to(self.device)
                 if n < mesh.n_node - 1 else self.fill)
        return left, right


class HaloExchange(torch.autograd.Function):
    """``(c, pos, h, mesh, pending) -> (c_left, c_right, pos_left,
    pos_right)``: the strips received from the left and right ring
    neighbours (``pending``, an exchange posted earlier on the same values,
    or one posted here).  Differentiable in c; pos gets no gradient."""

    @staticmethod
    def forward(ctx, c, pos, h: int, mesh,
                pending: Optional[PendingExchange] = None):
        ctx.h, ctx.mesh = h, mesh
        ctx.shape = c.shape
        left, right = (pending or PendingExchange(c, pos, h, mesh)).wait()
        H = c.shape[-1]
        pl, pr = left[..., H:].to(pos.dtype), right[..., H:].to(pos.dtype)
        ctx.mark_non_differentiable(pl, pr)
        return (left[..., :H].contiguous(), right[..., :H].contiguous(),
                pl.contiguous(), pr.contiguous())

    @staticmethod
    def backward(ctx, g_left, g_right, _gpl, _gpr):
        mesh, h = ctx.mesh, ctx.h
        B, n_loc, H = ctx.shape
        dc = torch.zeros(ctx.shape, dtype=g_left.dtype, device=g_left.device)
        if mesh.n_node == 1:
            return dc, None, None, None, None
        # each rank's cotangents of what it received, back to their owners
        parts = mesh.all_gather(torch.cat([g_left, g_right], dim=1),
                                mesh.node_group)
        n = mesh.node_index
        if n < mesh.n_node - 1:     # my right edge was my right neighbour's
            dc[:, n_loc - h:] += parts[n + 1][:, :h]       # from_left
        if n > 0:                   # my left edge was my left neighbour's
            dc[:, :h] += parts[n - 1][:, h:]               # from_right
        return dc, None, None, None, None


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.n_loc = mesh, t.shape[1]
        return torch.cat(mesh.all_gather(t, mesh.node_group), dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh, n = ctx.mesh, ctx.n_loc
        g = mesh.all_reduce(g.contiguous().clone(), mesh.node_group)
        return g[:, mesh.node_index * n:(mesh.node_index + 1) * n], None


def gather_nodes(t: torch.Tensor, mesh) -> torch.Tensor:
    """The node shards ``t [B, n_loc, ...]`` of this rank's node group
    concatenated along axis 1 in node order, ``[B, N, ...]``.  A float
    tensor's gradient is the reduce-scatter: the cotangents of every rank
    of the group summed, this rank's rows.  Integer and bool tensors carry
    none.  Identity on a node axis of 1."""
    if mesh.n_node == 1:
        return t
    if not t.is_floating_point():
        return torch.cat(mesh.all_gather(t, mesh.node_group), dim=1)
    return _GatherNodes.apply(t, mesh)


def ring_shift(t: torch.Tensor, mesh) -> torch.Tensor:
    """The ring rotation inside the node group: this rank sends ``t`` to
    node index ``(n + 1) mod N`` of its data row and returns the tensor of
    node index ``(n − 1) mod N`` (same shape and dtype), no gradient.  On a
    staged mesh both travel through host copies."""
    if mesh.n_node == 1:
        return t
    row = mesh.data_index * mesh.n_node
    send = t.detach().contiguous()
    if mesh.staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      row + (mesh.node_index + 1) % mesh.n_node),
           dist.P2POp(dist.irecv, recv,
                      row + (mesh.node_index - 1) % mesh.n_node)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device)
