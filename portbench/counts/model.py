"""Operations a step of each model needs, counted from the work by the
cheapest formulation the models allow (so no correct implementation
can read over 100 % of the peak): dense layers as per-node products,
EdgeConv's first layer split into per-node products, the max as H
comparisons per radius-graph edge, real nodes and real edges only.
Element-wise work (activations, BatchNorm, the loss) and the optimizer
are left out.  A training step counts each product three times (the
forward, and the gradients of its input and of its weight), the max once.
"""

from __future__ import annotations

from typing import Iterable, Mapping

from portbench.counts import edge_mlp, knn


def graphmet_node_macs(H: int, depth: int, continuous: int = 8) -> int:
    """Multiply-adds per real candidate of GraphMET's dense layers."""
    return (continuous * (H // 2) + (3 * H // 4) * (H // 2) + H * H
            + depth * 2 * H * H + H * (H // 2) + (H // 2))


def graphmet_ops(nodes: int, edges: int, H: int, depth: int,
                 train: bool) -> int:
    dense = 2 * graphmet_node_macs(H, depth) * nodes
    return (3 if train else 1) * dense + depth * H * edges


def drn_infer_ops(rounds: Iterable[Iterable[Mapping[str, int]]], F: int,
                  H: int, out: int) -> int:
    """An evaluation pass of the DRN over events whose per-round work
    (``n`` nodes, ``edges`` listed edges) is given: the input network per
    real node, per round the kNN build (``counts/knn.py``) and the
    EdgeConv (``counts/edge_mlp.py:conv_ops``), the output network once
    per event."""
    F1 = 3 * H // 2
    total = 0
    for event in rounds:
        event = list(event)
        total += 2 * (F * (H // 2) + (H // 2) * H + H * H) * event[0]["n"]
        for r in event:
            total += knn.ops([r["n"]], H)
            total += edge_mlp.conv_ops(r["n"], r["edges"], H, F1, H)
        total += 2 * (H * H + H * (H // 2) + (H // 2) * out)
    return total


def drn_train_ops(rounds: Iterable[Iterable[Mapping[str, int]]], F: int,
                  H: int, out: int) -> int:
    """A training step of the DRN over events whose per-round work is
    given: ``drn_infer_ops`` with every product counted three times (the
    forward, its input's and its weight's gradients) and the kNN build,
    which has no gradient, once."""
    rounds = [list(e) for e in rounds]
    knn_part = sum(knn.ops([r["n"]], H) for e in rounds for r in e)
    return 3 * (drn_infer_ops(rounds, F, H, out) - knn_part) + knn_part
