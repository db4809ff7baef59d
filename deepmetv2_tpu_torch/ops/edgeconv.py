"""EdgeConv — the message-passing op (the JAX package's ``ops/edgeconv.py``).

GraphMETNetwork's edge MLP is one ``Linear(2H → H)``; split over the
concat ``[x_i ‖ x_j − x_i]`` it is ``a_i + c_j``, so the max aggregation
factors exactly into ``a_i + max_j c_j`` (ops/window.edgeconv_terms).

Ported here: window graphs with 'max'.  Both devices go through the
``WindowMax`` autograd function (ops/cuda/edgeconv_window.py): the Hopper
kernels for a CUDA tensor, their plain PyTorch versions for a CPU tensor,
with the same tie rule in the gradient.  Neighbour-list graphs (ROADMAP
A8) and the sharded halo-exchange path (A12) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
    window_edgeconv_linear_cuda,
)
from deepmetv2_tpu_torch.ops.window import WindowGraph


def edgeconv(
    x: torch.Tensor,
    graph,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    reduction: str = "max",
) -> torch.Tensor:
    """Linear-MLP EdgeConv over a ``WindowGraph``."""
    if not isinstance(graph, WindowGraph):
        raise NotImplementedError(
            f"EdgeConv over {type(graph).__name__} is not ported yet; "
            "only WindowGraph (window mode)")
    if reduction != "max":
        raise NotImplementedError(f"reduction {reduction!r}: only 'max'")
    return window_edgeconv_linear_cuda(x, graph, weight, bias)
