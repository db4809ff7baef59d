"""Dense layers (the JAX package's ``nn/core.py``) as torch functions and
the modules that hold their parameters.

Linear weights keep the JAX package's ``[in, out]`` layout, so parameters
carry across unchanged.  Initialization follows torch's defaults
(uniform ±1/sqrt(fan_in) for Linear, N(0, 1) for Embedding), drawn from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

Params = Dict[str, torch.Tensor]


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """ELU (alpha=1) as ``where(x > 0, x, alpha·(exp(x) − 1))``."""
    safe = torch.where(x > 0, torch.zeros_like(x), x)  # no exp overflow
    return torch.where(x > 0, x, alpha * (torch.exp(safe) - 1.0))


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with ``w`` stored ``[in, out]``."""
    return torch.matmul(x, params["w"]) + params["b"]


def embedding_apply(params: Params, idx: torch.Tensor) -> torch.Tensor:
    return params["w"][idx.long()]


def mlp_apply(layers: Sequence[Params], x: torch.Tensor, act=elu,
              final_act: bool = False) -> torch.Tensor:
    n = len(layers)
    for i, p in enumerate(layers):
        x = linear_apply(p, x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


class BatchNormState(NamedTuple):
    """Running statistics (torch BatchNorm1d buffers), named as the JAX
    package names them; JAX checkpoints unpickle into this class."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # num_batches_tracked


def running_update(state: BatchNormState, mean: torch.Tensor,
                   var: torch.Tensor, n: torch.Tensor,
                   momentum: float = 0.1) -> BatchNormState:
    """The running buffers after one training batch whose biased
    statistics ``mean``, ``var`` were taken over ``n`` rows: momentum
    ``momentum``, the variance made unbiased (``var·n / max(n − 1, 1)``),
    the count plus one."""
    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
    return BatchNormState(
        (1 - momentum) * state.mean + momentum * mean,
        (1 - momentum) * state.var + momentum * unbiased,
        state.count + 1,
    )


def masked_moments(x: torch.Tensor, m: torch.Tensor, dims: Tuple[int, ...]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean, biased var, n)`` over the rows of ``x`` where ``m`` holds,
    reduced over ``dims``, in two passes: ``n`` and Σx, then Σ(x − mean)².
    In a mesh step (parallel/context.py) each of the three sums is taken
    over the ranks that hold the global batch, through the differentiable
    all-reduce, so the statistics are the global batch's, as GSPMD makes
    them in the JAX package's mesh steps; outside one they are this
    batch's, the same operations with no reduction between them."""
    from deepmetv2_tpu_torch.parallel.context import batch_sum

    total = batch_sum() or (lambda t: t)
    n = torch.clamp(total(m.sum()), min=1).to(x.dtype)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    mean = total(torch.where(m, x, zero).sum(dim=dims)) / n
    diff = torch.where(m, x - mean, zero)
    var = total((diff * diff).sum(dim=dims)) / n                  # biased
    return mean, var, n


def batchnorm_apply(
    params: Params,
    state: BatchNormState,
    x: torch.Tensor,       # [B, N, H]
    mask: torch.Tensor,    # [B, N]
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, BatchNormState]:
    """BatchNorm1d over the real nodes of the batch only: biased variance
    to normalize, unbiased for the running buffer, momentum 0.1 (reference
    model/graph_met_network.py:32,39).  Padded rows get garbage that every
    consumer masks.  In a mesh step the statistics are the global batch's
    (``masked_moments``)."""
    if train:
        mean, var, n = masked_moments(x, mask[..., None], (0, 1))
        new_state = running_update(state, mean, var, n, momentum)
    else:
        mean, var = state.mean, state.var
        new_state = state
    inv = torch.rsqrt(var + eps)
    out = (x - mean) * inv * params["gamma"] + params["beta"]
    return out, new_state


# ----------------------------------------------------------------- modules


def _uniform(shape, bound, generator, device, dtype):
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.uniform_(-bound, bound, generator=generator)


class Linear(nn.Module):
    """Linear layer with the weight stored ``[in, out]``."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.w = nn.Parameter(_uniform((in_dim, out_dim), bound, generator,
                                       device, dtype))
        self.b = nn.Parameter(_uniform((out_dim,), bound, generator,
                                       device, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_apply({"w": self.w, "b": self.b}, x)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        w = torch.empty((vocab, dim), device=device, dtype=dtype)
        self.w = nn.Parameter(w.normal_(generator=generator))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return embedding_apply({"w": self.w}, idx)


class MLP(nn.Module):
    """Linear layers with ELU between them (after the last too with
    ``final_act``)."""

    def __init__(self, dims: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], generator, device, dtype)
            for i in range(len(dims) - 1))

    def params(self) -> Dict[str, Params]:
        """``{'lin0': {'w', 'b'}, ...}``, the JAX package's MLP tree."""
        return {f"lin{i}": {"w": l.w, "b": l.b}
                for i, l in enumerate(self.layers)}

    def forward(self, x: torch.Tensor, final_act: bool = False
                ) -> torch.Tensor:
        return mlp_apply(list(self.params().values()), x,
                         final_act=final_act)


class MaskedBatchNorm(nn.Module):
    """``batchnorm_apply`` with its running statistics as buffers; batch
    statistics (and a buffer update) in training mode, running ones in eval."""

    def __init__(self, dim: int, device=None, dtype=torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.beta = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.register_buffer("running_mean",
                             torch.zeros(dim, device=device, dtype=dtype))
        self.register_buffer("running_var",
                             torch.ones(dim, device=device, dtype=dtype))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), device=device, dtype=torch.int64))

    def state(self) -> BatchNormState:
        return BatchNormState(self.running_mean, self.running_var,
                              self.num_batches_tracked)

    def _store(self, new: BatchNormState) -> None:
        with torch.no_grad():
            self.running_mean.copy_(new.mean)
            self.running_var.copy_(new.var)
            self.num_batches_tracked.copy_(new.count)

    def update_running(self, mean: torch.Tensor, var: torch.Tensor,
                       n: torch.Tensor, momentum: float = 0.1) -> None:
        """Fold a training batch's biased statistics over ``n`` rows into
        the buffers (``running_update``)."""
        with torch.no_grad():
            self._store(running_update(self.state(), mean, var, n, momentum))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        out, new = batchnorm_apply({"gamma": self.gamma, "beta": self.beta},
                                   self.state(), x, mask, self.training)
        if self.training:
            self._store(new)
        return out
