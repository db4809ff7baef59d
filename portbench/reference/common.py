"""Plain PyTorch pieces of the references: dense layers, ELU, BatchNorm,
and the lower-precision control's rounding.

Nothing here imports the port.  Every event is held as its real
candidates only (no padding): a batch is the rows of its events stacked,
with each row's event id.  Matrix products run in float32 with TF32 off
(the caller sets ``torch.backends.cuda.matmul.allow_tf32 = False``);
``Precision(tf32=True)`` rounds both operands of every product to TF32's
10-bit mantissa first, which is what a TF32 tensor-core product does to
its inputs, on either device, in the forward and in the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value (ties to even):
    the 13 low mantissa bits cleared."""
    bits = t.contiguous().view(torch.int32)
    low = bits & 0x1FFF
    keep = bits & ~0x1FFF
    half = 0x1000
    up = (low > half) | ((low == half) & ((keep & 0x2000) != 0))
    out = torch.where(up, keep + 0x2000, keep)
    finite = torch.isfinite(t)
    return torch.where(finite, out.view(torch.float32), t)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, and in the backward
    each product's operands rounded likewise, as TF32 GEMMs do."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = torch.matmul(g, b.transpose(-1, -2))
        gb = torch.matmul(a.reshape(-1, a.shape[-1]).transpose(0, 1),
                          g.reshape(-1, g.shape[-1]))
        return ga, gb.reshape(b.shape)


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference multiplies: float32, or with ``tf32`` both
    operands rounded to TF32 (the control)."""

    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a [..., k] @ b [k, m]``."""
        if self.tf32:
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)

    def linear(self, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        """``x @ W + b`` with ``W`` stored ``[in, out]`` under ``name``."""
        return self.mm(x, p[f"{name}.w"]) + p[f"{name}.b"]


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.elu(x)


def batchnorm(p: dict, name: str, x: torch.Tensor, train: bool,
              eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm1d over the rows of ``x`` (the real candidates or edges):
    batch statistics with the biased variance in training, the running
    buffers otherwise."""
    if train:
        mean = x.mean(dim=0)
        var = ((x - mean) ** 2).mean(dim=0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    return ((x - mean) * torch.rsqrt(var + eps) * p[f"{name}.gamma"]
            + p[f"{name}.beta"])


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Sum of ``values`` rows into ``n`` segments by ``seg``."""
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add(0, seg, values)


class Steps(NamedTuple):
    """A reference's training steps, by leaf name (trainable leaves):
    each step's loss, the first step's gradient as the optimizer gets it,
    the parameters after each step, AdamW's first moment after the last,
    and, of each step's graph decisions, the faults found in them and the
    matching's gap (reference/drn.py:match_gap): the DRN's; 0 for GraphMET,
    whose graph the reference builds itself."""

    losses: List[float]
    first: Dict[str, torch.Tensor]
    after: List[Dict[str, torch.Tensor]]
    moment: Dict[str, torch.Tensor]
    faults: List[int]
    match: List[float]
