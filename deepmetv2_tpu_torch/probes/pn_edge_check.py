"""The card's check of ParticleNet's kernels (``csrc/pn_edge.cu`` and the
directed extraction of ``csrc/knn_und.cu``):

    python -m deepmetv2_tpu_torch.probes.pn_edge_check [--quick]

Prints one JSON line per part, then the card's name and power limit:

* ``build``: the ptxas report of ``pn_edge.cu`` (registers, spills);
* ``knn``: the directed and the undirected extraction against their plain
  versions (ops/knn_und.py) bit for bit at H = 2, 64, 128, with padded rows
  and tied points;
* ``edge``: the edge block's forward (output and statistics) and every
  gradient of its backward against the plain version in float64, as the
  largest gap over the largest reference magnitude, at each width; a
  second call and a CUDA graph replay of forward and backward bit for bit
  equal to the first call; beside them the plain version's own gap in
  float32 (``plain_f32``, the worst gradient's) and the ReLU inputs
  within ``KINK`` of zero (``near_kink``).  Where one lies there, float32
  and float64 may take its ReLU's decision differently, which moves every
  gradient upstream of it by a whole term: the gradients agree to
  rounding only where ``near_kink`` is 0;
* without ``--quick``, ``time``: forward plus backward device time (CUDA
  events) at B = 16, N = 8192, K = 16, C = 256 with the cell's candidate
  counts and with half of them, and the plain version's at the first.

It needs a CUDA GPU and ``nvcc``; it writes only under ``build/kernels/``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence, Tuple

import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops import knn_und as plain_knn
from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.ops.cuda import knn_und as knn
from deepmetv2_tpu_torch.ops.cuda import pn_edge
from deepmetv2_tpu_torch.ops.pn_edge import edge_block_torch
from deepmetv2_tpu_torch.probes import common

K = 16
KINK = 1e-4     # |ReLU input| under which float32 may decide otherwise
GAPS = ("y", "stats", "dx", "dw1", "dw2", "dw3", "dgamma", "dbeta")


def inputs(B: int, N: int, counts: List[int], cin: int, device, seed: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x [B, N, cin], pts [B, N, 2], mask [B, N])``: each event's real
    nodes first, padded rows of x zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.arange(N, device=device)[None, :]
            < torch.tensor(counts, device=device)[:, None])
    x = torch.randn((B, N, cin), generator=gen, device=device) * mask[..., None]
    pts = torch.rand((B, N, 2), generator=gen, device=device) * 6 - 3
    return x, pts, mask


def lists(pts: torch.Tensor, mask: torch.Tensor) -> Neighborhood:
    t, sq = knn.knn_kth(pts, mask, K)
    idx, d2v, _ = knn.knn_extract(pts, mask, t, sq, K, directed=True)
    return plain_knn.neighborhood(idx, d2v, mask)[0]


def weights(cin: int, C: int, device, seed: int, shift: float = 0.0):
    """``[w1, w2, w3, gamma, beta]``; ``shift`` moves each BatchNorm's
    beta to +shift on even and −shift on odd channels, so that the ReLU
    inputs keep away from zero (each channel all but always on or off)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1
                ) / shape[0] ** 0.5

    gamma = 1 + 0.1 * torch.randn((3, C), generator=gen, device=device)
    beta = 0.1 * torch.randn((3, C), generator=gen, device=device)
    sign = 1 - 2 * (torch.arange(C, device=device) % 2)
    return [u(2 * cin, C), u(C, C), u(C, C), gamma, beta + shift * sign]


def cell_counts(B: int = 16) -> List[int]:
    """Real candidates per event spread over the cell's 500-5000."""
    return [500 + (4500 * i) // max(B - 1, 1) for i in range(B)]


def check_knn(device, B: int = 2, N: int = 1024,
              counts: Sequence[int] = (700, 300)) -> Dict[str, bool]:
    """The directed and the undirected extraction (and ``knn_kth``) bit
    for bit against the plain versions at H = 2, 64, 128, each event's
    real rows first, with tied points."""
    out = {}
    for H in (2, 64, 128):
        gen = torch.Generator(device=device).manual_seed(H)
        h = torch.randn((B, N, H), generator=gen, device=device)
        h[:, 50:60] = h[:, 40:50]                  # tied points
        mask = torch.arange(N, device=device)[None] < torch.tensor(
            list(counts), device=device)[:, None]
        t, sq = knn.knn_kth(h, mask, K)
        tp, sqp = plain_knn.knn_kth_torch(h, mask, K)
        ok = torch.equal(t, tp) and torch.equal(sq, sqp)
        for directed in (True, False):
            cap = K if directed else 2 * K
            a = knn.knn_extract(h, mask, t, sq, cap, False, directed)
            b = plain_knn.knn_extract_torch(h, mask, t, sq, cap, False,
                                            directed)
            out[f"H{H}_{'directed' if directed else 'undirected'}"] = (
                ok and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
    return out


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def run_block(x, nbr, cnt, n_edges, ws, gy):
    """Forward and backward on the card: y, stats and the gradients."""
    leaves = [x] + ws
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    y, stats = pn_edge.PNEdge.apply(*leaves, nbr.idx, nbr.mask, cnt, n_edges)
    grads = torch.autograd.grad(y, leaves, gy)
    return [y.detach(), stats] + list(grads)


def near_kink(x, nbr, cnt, n_edges, ws) -> int:
    """The real edges' ReLU inputs within ``KINK`` of zero, over the three
    layers, from the kernel's own forward (z · s + t)."""
    _, z, st, _ = pn_edge.pn_edge_fwd(x, nbr, cnt, n_edges, *ws, True)
    real = nbr.mask.reshape(-1)
    return sum(int(((z[layer][real] * st[layer, 0] + st[layer, 1]).abs()
                    < KINK).sum()) for layer in range(3))


def plain_grads(x, nbr, ws, gy, dtype):
    leaves = [t.to(dtype).requires_grad_(True) for t in [x] + ws]
    y, stats = edge_block_torch(leaves[0], nbr, *leaves[1:], True)
    return [y.detach(), stats] + list(torch.autograd.grad(y, leaves,
                                                          gy.to(dtype)))


def check_edge(device, cin: int, C: int, B: int = 2, N: int = 1024,
               counts: Sequence[int] = (700, 300), shift: float = 0.0
               ) -> Dict[str, float]:
    """The edge block's forward and every gradient (``GAPS``) against the
    plain version in float64 (the largest gap over the largest magnitude),
    the plain version's own float32 gap (``plain_f32``, its worst
    gradient's), ``near_kink``, and a second call and a graph replay bit
    for bit equal to the first.  ``shift``: see ``weights``."""
    counts = list(counts)
    x, pts, mask = inputs(B, N, counts, cin, device, C)
    nbr = lists(pts, mask)
    ws = weights(cin, C, device, C + 1, shift)
    gen = torch.Generator(device=device).manual_seed(C + 2)
    gy = torch.randn((B, N, C), generator=gen, device=device) * mask[..., None]
    cnt = torch.tensor(counts, dtype=torch.int32, device=device)
    n_edges = nbr.mask.sum().double().reshape(1)
    got = run_block(x, nbr, cnt, n_edges, ws, gy)
    again = run_block(x, nbr, cnt, n_edges, ws, gy)

    want = plain_grads(x, nbr, ws, gy, torch.float64)
    out = {n: gap(a, b) for n, a, b in zip(GAPS, got, want)}
    out["plain_f32"] = max(gap(a, b) for a, b in zip(
        plain_grads(x, nbr, ws, gy, torch.float32)[2:], want[2:]))
    del want
    out["near_kink"] = near_kink(x, nbr, cnt, n_edges, ws)
    out["repeat_bitwise"] = all(torch.equal(a, b) for a, b in zip(got, again))

    static = [t.clone() for t in (x, gy)]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        run_block(static[0], nbr, cnt, n_edges, ws, static[1])
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        replayed = run_block(static[0], nbr, cnt, n_edges, ws, static[1])
    graph.replay()
    torch.cuda.synchronize(device)
    out["replay_bitwise"] = all(torch.equal(a, b)
                                for a, b in zip(got, replayed))
    return out


def time_edge(device) -> Dict[str, float]:
    B, N, cin, C = 16, 8192, 128, 256
    counts = cell_counts(B)
    out = {}
    for name, cs in (("full", counts), ("half", [c // 2 for c in counts])):
        x, pts, mask = inputs(B, N, cs, cin, device, 7)
        nbr = lists(pts, mask)
        ws = weights(cin, C, device, 8)
        gy = torch.randn((B, N, C), device=device) * mask[..., None]
        cnt = torch.tensor(cs, dtype=torch.int32, device=device)
        n_edges = nbr.mask.sum().double().reshape(1)
        out[f"{name}_real_nodes"] = sum(cs)
        out[f"{name}_ms"] = common.ms(
            lambda: run_block(x, nbr, cnt, n_edges, ws, gy), 5)
        if name == "full":
            leaves = [t.clone().requires_grad_(True) for t in [x] + ws]

            def plain():
                y, _ = edge_block_torch(leaves[0], nbr, *leaves[1:], True)
                torch.autograd.grad(y, leaves, gy)

            out["plain_ms"] = common.ms(plain, 2)
    out["half_over_full"] = out["half_ms"] / out["full_ms"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true")
    args = p.parse_args(argv)
    device = common.cuda_device("pn_edge_check")
    if device is None:
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep = build.build(["pn_edge", "knn_und", "edge_mlp"])
    log = rep.get("pn_edge", {}).get("log", "")
    print(json.dumps({"build": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]}),
          flush=True)
    print(json.dumps({"knn": check_knn(device)}), flush=True)
    for cin, C in ((11, 64), (64, 128), (128, 256)):
        print(json.dumps({"edge": {"cin": cin, "C": C,
                                   **check_edge(device, cin, C)}}),
              flush=True)
    if not args.quick:
        print(json.dumps({"time": time_edge(device)}), flush=True)
    common.print_device()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
