"""EdgeConv — the message-passing op (the JAX package's ``ops/edgeconv.py``).

GraphMETNetwork's edge MLP is one ``Linear(2H → H)``; split over the
concat ``[x_i ‖ x_j − x_i]`` it is ``a_i + c_j``, so the max aggregation
factors exactly into ``a_i + max_j c_j`` (ops/window.edgeconv_terms).

Ported here: window graphs with 'max'.  A CUDA tensor goes through the
Hopper kernel, a CPU tensor through the plain PyTorch version; the choice
follows the tensor's device.  Neighbour-list graphs (ROADMAP A8) and the
sharded halo-exchange path (A12) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepmetv2_tpu_torch.ops.window import WindowGraph, window_edgeconv_linear


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
    if x.is_cuda:
        from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
            window_edgeconv_linear_cuda,
        )

        return window_edgeconv_linear_cuda(x, graph, weight, bias)
    return window_edgeconv_linear(x, graph, weight, bias, reduction)
