"""What ParticleNet needs, from the inputs alone: the edge block's kernels
(``csrc/pn_edge.cu``) and a training step of the model.

Per EdgeConv block of ``n`` real candidates at input width ``cin`` and
width ``C`` with ``E`` real edges (directed, ``n · min(k, n − 1)`` per
event):

* the edge block's forward: the first layer as per-node products (``a``
  and ``p``, 4 cin C per node), its gather-add (C per edge), then two
  layers of 2 C² per edge; bytes: x at the real rows, the weights, the
  lists at the real rows (index and mask), the whole output;
* its backward: per edge the two layers' input and weight gradients
  (8 C² in all) and the first layer's sums onto both ends (2 C); per node
  the first layer's input and weight gradients (8 cin C); bytes: x and the
  cotangent at the real rows, the weights, the lists, the whole dx.

Element-wise work (BatchNorm, ReLU, the mean) is left out of the
operations and its re-reads out of the bytes, so no correct
implementation reads over 100 % of the bound.

"""

from __future__ import annotations

from typing import Sequence, Tuple


def fusion_widths(conv_params) -> Tuple[int, int]:
    """The fusion's input (the blocks' widths summed) and output width,
    by weaver-core's rule: the input rounded down to a multiple of 128,
    clipped to 128..1024."""
    fused = sum(int(w[-1]) for w in conv_params)
    return fused, min(max(fused // 128 * 128, 128), 1024)


def edges(n_per_event: Sequence[int], k: int) -> int:
    return int(sum(n * min(k, max(n - 1, 0)) for n in n_per_event))


def fwd_ops(nodes: int, E: int, cin: int, C: int) -> int:
    return 4 * cin * C * nodes + C * E + 4 * C * C * E


def bwd_ops(nodes: int, E: int, cin: int, C: int) -> int:
    return 8 * cin * C * nodes + (8 * C * C + 2 * C) * E


def fwd_bytes(nodes: int, B: int, N: int, k: int, cin: int, C: int) -> int:
    weights = 2 * cin * C + 2 * C * C
    return 4 * (cin * nodes + weights + B * N * C) + 5 * nodes * k


def bwd_bytes(nodes: int, B: int, N: int, k: int, cin: int, C: int) -> int:
    weights = 2 * cin * C + 2 * C * C
    return (4 * (cin * nodes + C * nodes + 2 * weights + B * N * cin)
            + 5 * nodes * k)


def train_ops(n_per_event: Sequence[int], pn: dict) -> int:
    """A training step over events of ``n_per_event`` real candidates:
    per block the kNN build (counts/knn.py, once: no gradient) and three
    times (the forward, its input's and its weight's gradients) the
    products: the edge block's (``fwd_ops``), the shortcut's (2 cin C per
    node), the fusion's per node and the FC layers' per event."""
    from portbench.counts import knn

    k = int(pn["k"])
    nodes = int(sum(n_per_event))
    events = sum(1 for n in n_per_event if n > 0)
    E = edges(n_per_event, k)
    cin, products, build = int(pn["input_dim"]), 0, 0
    for b, widths in enumerate(pn["conv_params"]):
        C = int(widths[-1])
        build += knn.ops(n_per_event, 2 if b == 0 else cin)
        products += fwd_ops(nodes, E, cin, C) + 2 * cin * C * nodes
        cin = C
    fused, fusion = fusion_widths(pn["conv_params"])
    products += 2 * fused * fusion * nodes
    products += 2 * events * (fusion * int(pn["fc"]) + int(pn["fc"]) * 2)
    return 3 * products + build
