"""What GraphMET's window-max kernels need, from the inputs alone.

For one call on a batch with ``real`` candidate rows of ``B x N`` padded
rows, ``H`` features and ``edges`` directed radius-graph pairs (self pairs
included, real rows only):

* forward: the predicate (six operations: two differences, two products,
  a sum, a compare) and H comparisons per edge; bytes: c at the real rows,
  the whole output and (eta, phi) of every row;
* backward: the predicate and 2H operations per edge (the selection and
  the gradient's sum); bytes: c, the forward's output and its gradient at
  the real rows, the whole output and (eta, phi).

Only the pairs the radius graph holds are counted, never the window's
other pairs, so a kernel that skips more of them cannot pass its bound.
"""

from __future__ import annotations


def fwd_ops(edges: int, H: int) -> int:
    return (6 + H) * edges


def bwd_ops(edges: int, H: int) -> int:
    return (6 + 2 * H) * edges


def nbytes(real: int, B: int, N: int, H: int, reads: int) -> int:
    """``reads`` [rows, H] float32 inputs at the real rows, one whole
    [B, N, H] output, and (eta, phi) of every row."""
    return 4 * (reads * H * real + B * N * H + 2 * B * N)
