"""The kNN kernels (csrc/knn_und.cu) against their plain versions
(ops/knn_und.py) at the cells' bucket, N=8192, bit for bit: thresholds,
squared norms, lists and listed distances, undirected and directed, at
H = 2, 64 and 128.  Events hold 500, 2700 and 5000 real nodes, and one
below and one above a multiple of the kernels' 64-row query tile; one event
starts with 100 copies of one node (rows far past the cap), one repeats its
nodes in pairs (ties at the k-th distance) and one sits on an integer
lattice (many equal distances).

These tests need a CUDA card and skip without one:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_knn_card.py

(``--noconftest``: the tests' conftest imports JAX, which the card's
machine does not have; this file imports neither JAX nor the JAX
package.)
"""

import numpy as np
import pytest
import torch

from deepmetv2_tpu_torch.ops import knn_und as plain
from deepmetv2_tpu_torch.ops.cuda import knn_und as kernels

N, K = 8192, 16
COUNTS = (500, 2700, 5000, 9 * 64 - 1, 9 * 64 + 1, 5000)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def events(H: int, device) -> tuple:
    """``(h [6, N, H], mask [6, N])`` with prefix masks of ``COUNTS``:
    event 0 starts with 100 copies of its first node, event 1 repeats its
    nodes in pairs, event 5 is an integer lattice, the others normal."""
    rng = np.random.default_rng(H)
    h = rng.normal(size=(len(COUNTS), N, H)).astype(np.float32)
    h[0, 1:100] = h[0, 0]
    h[1, 1:COUNTS[1]:2] = h[1, 0:COUNTS[1] - 1:2]
    h[5] = rng.integers(-2, 3, size=(N, H))
    mask = np.arange(N)[None] < np.asarray(COUNTS)[:, None]
    h = np.where(mask[..., None], h, 0.0).astype(np.float32)
    return (torch.as_tensor(h, device=device),
            torch.as_tensor(mask, device=device))


@pytest.mark.card
@pytest.mark.parametrize("H", [2, 64, 128])
@pytest.mark.parametrize("directed", [False, True], ids=["undirected",
                                                         "directed"])
def test_knn_kernels_equal_the_plain_versions_at_8192(card, H, directed):
    h, mask = events(H, card)
    t, sq = kernels.knn_kth(h, mask, K)
    tp, sqp = plain.knn_kth_torch(h, mask, K)
    assert torch.equal(sq, sqp)
    assert torch.equal(t, tp)
    cap = K if directed else 2 * K
    idx, d2v, _ = kernels.knn_extract(h, mask, tp, sqp, cap, False, directed)
    idx_p, d2v_p, _ = plain.knn_extract_torch(h, mask, tp, sqp, cap, False,
                                              directed)
    assert torch.equal(idx, idx_p)
    assert torch.equal(d2v, d2v_p)
    # the copies' rows relate to 99 nodes at d2 = 0: past the cap
    assert bool((d2v_p[0, 0] == 0).all())
    d2_0 = plain.event_d2(h[0, :COUNTS[0]], sq[0, :COUNTS[0]])[0, 1:]
    assert int((d2_0 <= tp[0, 0]).sum()) > cap


@pytest.mark.card
def test_knn_kernels_refuse_k_past_128(card):
    h, mask = events(2, card)
    with pytest.raises(ValueError, match="k=129"):
        kernels.knn_kth(h, mask, 129)
    t, sq = kernels.knn_kth(h, mask, K)
    with pytest.raises(ValueError, match="cap=129"):
        kernels.knn_extract(h, mask, t, sq, 129)
