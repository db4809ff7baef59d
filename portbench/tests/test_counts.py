import pytest
import torch

from portbench.counts import edge_mlp, knn, model, peaks, window
from portbench.reference import graphmet as ref


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e9, 67e12) == pytest.approx(1.0)


def test_window_counts_by_hand():
    # 2 real rows of one event padded to 4, H=2, 3 edges
    assert window.fwd_ops(3, 2) == 3 * 8
    assert window.bwd_ops(3, 2) == 3 * 10
    assert window.nbytes(2, 1, 4, 2, 1) == 4 * (2 * 2 + 4 * 2 + 2 * 4)


def test_radius_edges_by_hand():
    eta = torch.tensor([0.0, 0.3, 0.5, 2.0])
    phi = torch.tensor([0.0, 0.0, 0.0, 0.0])
    src, dst = ref.radius_edges(eta, phi, 0.4)
    pairs = set(zip(dst.tolist(), src.tolist()))
    assert pairs == {(0, 0), (1, 1), (2, 2), (3, 3), (0, 1), (1, 0),
                     (1, 2), (2, 1)}


def test_knn_and_edge_mlp_counts_by_hand():
    assert knn.ops([3], 2) == 2 * 3 * 2 + 2 * 2 * 3
    assert knn.nbytes([3], 1, 4, 2) == 4 * 2 * 3 + 4 + 8 * 4
    assert knn.nbytes([3], 1, 4, 2, cap=2) == 4 * 2 * 3 + 4 + 8 * 4 + 48
    assert edge_mlp.kernel_ops(2, 3, 1, 2, 1) == 2 * 1 * 2 * 2 + 3 * (4 + 3)
    assert edge_mlp.conv_ops(2, 3, 1, 2, 1) == 4 * 1 * 2 * 2 + 3 * (4 + 3)


def test_model_counts_by_hand():
    H, depth = 32, 2
    macs = 8 * 16 + 24 * 16 + 32 * 32 + 2 * 2 * 32 * 32 + 32 * 16 + 16
    assert model.graphmet_node_macs(H, depth) == macs
    assert model.graphmet_ops(10, 7, H, depth, False) == 2 * macs * 10 + 2 * 32 * 7
    assert model.graphmet_ops(10, 7, H, depth, True) == 6 * macs * 10 + 2 * 32 * 7
    rounds = [[{"n": 3, "edges": 4}, {"n": 2, "edges": 2}]]
    F, Hd = 11, 4
    want = (2 * (11 * 2 + 2 * 4 + 4 * 4) * 3
            + knn.ops([3], Hd) + edge_mlp.conv_ops(3, 4, Hd, 6, Hd)
            + knn.ops([2], Hd) + edge_mlp.conv_ops(2, 2, Hd, 6, Hd)
            + 2 * (4 * 4 + 4 * 2 + 2 * 2))
    assert model.drn_infer_ops(rounds, F, Hd, 2) == want
