"""ParticleNet's EdgeConv edge block in plain PyTorch: the CPU path and the
oracle of the CUDA kernels (ops/cuda/pn_edge.py, csrc/pn_edge.cu).

For node features ``x [B, N, Cin]`` and directed neighbour lists ``nbr``
(``idx``, ``mask [B, N, K]``; the mask holds at slots with a real
neighbour), three 1x1 convolutions without bias over the edge features
``[x_i, x_j − x_i]``, each followed by BatchNorm over the real edges and
ReLU, then the mean over each node's real slots (weaver-core's
``EdgeConvBlock`` before its shortcut).  The first layer is factored as
the kernels factor it: ``x_i·(w1a − w1b) + x_j·w1b`` for ``w1 = [w1a;
w1b]``, a per-node product and a gather.

In training the BatchNorm takes the biased statistics of the real edges
(``nn/core.py:masked_moments``), which it also returns for the running
buffers; in evaluation the running ones.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.nn.core import masked_moments
from deepmetv2_tpu_torch.ops.segment import gather_neighbors

EPS = 1e-5


def edge_block_torch(x: torch.Tensor, nbr: Neighborhood, w1: torch.Tensor,
                     w2: torch.Tensor, w3: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, train: bool,
                     running: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
                     eps: float = EPS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, N, C], stats [3, 2, C])``: the block's mean over the real
    slots (0 for a node with none) and, in training, each layer's biased
    mean and variance over the real edges (in evaluation ``running``'s
    ``(mean, var)`` per layer are used and returned).  ``gamma``,
    ``beta``: ``[3, C]``."""
    cin = x.shape[-1]
    a = torch.matmul(x, w1[:cin] - w1[cin:])
    p = torch.matmul(x, w1[cin:])
    m = nbr.mask[..., None]
    z = a[:, :, None, :] + gather_neighbors(p, nbr)
    stats = []
    for layer, w in enumerate((None, w2, w3)):
        if w is not None:
            z = torch.matmul(h, w)
        if train:
            mean, var, _ = masked_moments(z, m, (0, 1, 2))
        else:
            mean, var = running[layer]
        stats.append(torch.stack([mean, var]).detach())
        h = torch.relu((z - mean) * torch.rsqrt(var + eps) * gamma[layer]
                       + beta[layer])
    deg = nbr.mask.sum(-1, keepdim=True).to(x.dtype)
    y = torch.where(m, h, torch.zeros_like(h)).sum(2) / deg.clamp(min=1)
    return y, torch.stack(stats)
