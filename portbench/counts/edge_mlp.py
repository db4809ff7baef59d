"""What the DRN's fused edge-MLP forward needs, from the inputs alone.

Linear(2H, F1)+ELU+Linear(F1, H2)+ELU per edge on ``[x_i, x_j - x_i]``:
its first layer splits into per-node products (``x (W_self - W_diff)`` and
``x W_diff``, 4 H F1 operations per real node), then per listed edge an
add of F1 values and the second layer (2 F1 H2) and the sum of H2 into
its row.  The kernel takes the first product ``a`` as input and computes
the second, so its own count is 2 H F1 per node.  Bytes: a, x and the
slots' indices at the real rows, the weights, the whole output, the slot
mask.
"""

from __future__ import annotations


def kernel_ops(nodes: int, edges: int, H: int, F1: int, H2: int) -> int:
    return 2 * H * F1 * nodes + (2 * F1 * H2 + F1 + H2) * edges


def conv_ops(nodes: int, edges: int, H: int, F1: int, H2: int) -> int:
    """The whole EdgeConv, both per-node products included."""
    return 4 * H * F1 * nodes + (2 * F1 * H2 + F1 + H2) * edges


def bwd_ops(nodes: int, edges: int, H: int, F1: int, H2: int) -> int:
    """The backward of the whole EdgeConv: per listed edge the second
    layer's weight gradient and its input's (2 F1 H2 each); per real node
    the first layer's two products' input and weight gradients (4 H F1)."""
    return 4 * H * F1 * nodes + 4 * F1 * H2 * edges


def nbytes(nodes: int, B: int, N: int, K: int, H: int, F1: int,
           H2: int) -> int:
    return (4 * (nodes * (F1 + H + K) + H * F1 + F1 * H2 + H2 + B * N * H2)
            + B * N * K)
