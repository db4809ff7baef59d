"""What the DRN's kNN kernels need, from the inputs alone.

Each of ``knn_kth`` (the k-th distance of every row) and ``knn_extract``
(the members within it) needs every pair of real nodes of an event once
(d^2 is symmetric), one multiply and one add per feature, plus the
squared norms: ``H n (n - 1) + 2 H n`` per event.  Bytes: the features at
the real rows, the mask, the thresholds and squared norms; the
extraction also writes each real row's ``cap`` slots (index and d^2).
"""

from __future__ import annotations

from typing import Sequence


def ops(n_per_event: Sequence[int], H: int) -> int:
    return int(sum(H * n * (n - 1) + 2 * H * n for n in n_per_event))


def nbytes(n_per_event: Sequence[int], B: int, N: int, H: int,
           cap: int = 0) -> int:
    real = int(sum(n_per_event))
    return 4 * H * real + B * N + 8 * B * N + 8 * real * cap
