"""ParticleNet in plain PyTorch (Qu & Gouskos, "Jet Tagging via Particle
Clouds", arXiv:1902.08570; weaver-core ``networks/example_ParticleNet.py``
and ``weaver/nn/model/ParticleNet.py``), in training mode, on a batch of
events held as their real candidates stacked.

``fts = BN(features)``; per EdgeConv block with k = 16: the k nearest
neighbours of each candidate (self excluded) in the block's points, (eta,
phi) for the first block and the previous block's output for the others;
the edge features ``[x_i, x_j − x_i]``; three 1x1 convolutions without
bias, each followed by BatchNorm and ReLU; the mean over the k edges; the
shortcut ``BN(x·W_sc)`` added, ReLU.  Then the fusion of the three
blocks' outputs (1x1 convolution 448 → 384, BatchNorm, ReLU), the mean
over the candidates, FC 384 → 256 with ReLU and dropout 0.1, and the last
linear layer.  Float32, every product by ``Precision.mm`` (TF32 off; the
caller sets ``allow_tf32`` False for matmul and cuDNN); nothing of the
port is imported.

Departures from the published description, each the configuration's
(``configs/particlenet-k16-f32.json``, ``assumed``):

* the inputs are the DRN's eleven candidate features and (eta, phi =
  atan2(py, px)) of each candidate, with no jet axis and no phi wrap;
* the last linear layer gives the MET's (x, y) times ``output_scale``,
  trained with 0.5 · mean |v − genMET|² (the DRN's cartesian loss) in
  place of the classification;
* every BatchNorm takes its statistics over the real candidates or the
  real edges of the batch (biased variance), where weaver's counts padded
  positions too;
* an event with k or fewer candidates lists them all (weaver's would
  repeat padding).

The neighbour lists and the dropout masks are decisions of the run: the
lists rest on float32 distances whose near ties are rounding, the masks on
the run's generator.  So ``train_steps`` takes both from the run being
judged, and ``check_lists`` judges each event's lists
against this module's own float64 distances: every listed neighbour lies
within the row's k-th distance, and every candidate closer than it is
listed, both up to ``tol (|p_i|² + |p_j|²)``.  The forward is computed per
block over all the batch's edges at once (about 0.7 GB a 256-wide edge
tensor at the cell's size), well inside the card beside the run's freed
memory.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from portbench.reference.common import Precision, Steps


class Lists(NamedTuple):
    """One event's lists in one block: ``idx [n, k]`` (indices into the
    event's candidates) and ``valid [n, k]``."""

    idx: torch.Tensor
    valid: torch.Tensor


def points(x: torch.Tensor) -> torch.Tensor:
    """``[n, 2]``: (eta, phi = atan2(py, px)) of candidates ``x [n, 11]``."""
    return torch.stack([x[:, 3], torch.atan2(x[:, 1], x[:, 0])], dim=1)


def masked_bn(p: dict, name: str, z: torch.Tensor, m: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over the rows of ``z [rows, C]`` where ``m [rows]`` holds,
    with their biased statistics."""
    w = m.to(z.dtype)[:, None]
    n = w.sum().clamp(min=1.0)
    mean = (z * w).sum(0) / n
    var = (((z - mean) ** 2) * w).sum(0) / n
    return ((z - mean) * torch.rsqrt(var + eps) * p[f"{name}.gamma"]
            + p[f"{name}.beta"])


def edge_conv(p: dict, b: int, x: torch.Tensor, idx: torch.Tensor,
              valid: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Block ``b`` on the batch's candidates ``x [n, C_in]`` and lists
    ``idx``, ``valid [n, k]`` (indices into the batch's rows)."""
    n, k = idx.shape
    xi = x[:, None, :].expand(n, k, x.shape[1])
    xj = x[idx]
    h = torch.cat([xi, xj - xi], dim=2).reshape(n * k, -1)
    m = valid.reshape(-1)
    for layer in range(3):
        h = prec.mm(h, p[f"blocks.{b}.convs.{layer}.w"])
        h = torch.relu(masked_bn(p, f"blocks.{b}.bns.{layer}", h, m))
    h = h.reshape(n, k, -1) * valid[..., None].to(h.dtype)
    deg = valid.sum(1, keepdim=True).clamp(min=1).to(h.dtype)
    y = h.sum(1) / deg
    every = torch.ones(n, dtype=torch.bool, device=x.device)
    sc = masked_bn(p, f"blocks.{b}.sc_bn",
                   prec.mm(x, p[f"blocks.{b}.sc.w"]), every)
    return torch.relu(y + sc)


def forward(p: dict, events: Sequence[torch.Tensor],
            lists: Sequence[Sequence[Lists]], keep: Optional[torch.Tensor],
            cfg: dict, prec: Precision) -> torch.Tensor:
    """``[E, 2]``: each event's MET (x, y) in training mode on the given
    lists (``lists[e][b]``) and dropout mask ``keep [E, fc]`` (None: no
    dropout)."""
    dev = events[0].device
    sizes = [ev.shape[0] for ev in events]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    X = torch.cat(list(events)).float()
    seg = torch.repeat_interleave(torch.arange(len(events), device=dev),
                                  torch.tensor(sizes, device=dev))
    every = torch.ones(X.shape[0], dtype=torch.bool, device=dev)
    x = masked_bn(p, "bn_fts", X, every)
    outs = []
    for b in range(len(cfg["conv_params"])):
        idx = torch.cat([ls[b].idx.long() + o
                         for ls, o in zip(lists, offs)])
        valid = torch.cat([ls[b].valid for ls in lists])
        x = edge_conv(p, b, x, idx, valid, prec)
        outs.append(x)
    f = prec.mm(torch.cat(outs, dim=1), p["fusion.w"])
    f = torch.relu(masked_bn(p, "fusion_bn", f, every))
    pooled = torch.zeros((len(events), f.shape[1]), dtype=f.dtype,
                         device=dev).index_add(0, seg, f)
    pooled = pooled / torch.tensor(sizes, dtype=f.dtype, device=dev)[:, None]
    h = torch.relu(prec.mm(pooled, p["fc.w"]) + p["fc.b"])
    if keep is not None:
        h = h * keep / (1.0 - float(cfg["dropout"]))
    return (prec.mm(h, p["out.w"]) + p["out.b"]) * float(cfg["output_scale"])


def sqdist(h: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ``[n, n]`` in float64, by differences."""
    h = h.double()
    return torch.cdist(h, h, compute_mode="donot_use_mm_for_euclid_dist") ** 2


def own_lists(h: torch.Tensor, k: int) -> Lists:
    """Each candidate's k nearest others in ``h [n, H]`` by float64
    distances (all of them where the event has k or fewer others)."""
    n = h.shape[0]
    d2 = sqdist(h)
    d2.fill_diagonal_(math.inf)
    c = min(k, n - 1)
    idx = torch.zeros((n, k), dtype=torch.int64, device=h.device)
    valid = torch.zeros((n, k), dtype=torch.bool, device=h.device)
    if c >= 1:
        idx[:, :c] = torch.topk(d2, c, dim=1, largest=False).indices
        valid[:, :c] = True
    return Lists(idx, valid)


def check_lists(h: torch.Tensor, ls: Lists, k: int, tol: float) -> int:
    """Faults in one event's lists on its points ``h [n, H]``: a slot
    outside the event or at the row itself, a neighbour listed twice, a
    listed neighbour beyond the row's k-th distance, a candidate closer
    than it and not listed, each past the margin ``tol (|h_i|² + |h_j|²)``,
    and a row with other than min(k, n − 1) valid slots."""
    n = h.shape[0]
    if n == 0:
        return 0
    iota = torch.arange(n, device=h.device)
    idx, valid = ls.idx.long(), ls.valid
    faults = int((valid & ((idx < 0) | (idx >= n)
                           | (idx == iota[:, None]))).sum())
    faults += int((valid.sum(1) != min(k, n - 1)).sum())
    idx = idx.clamp(0, n - 1)
    listed = torch.zeros((n, n), dtype=torch.int64, device=h.device)
    listed.index_put_((iota[:, None].expand_as(idx)[valid], idx[valid]),
                      torch.ones_like(idx[valid]), accumulate=True)
    faults += int((listed > 1).sum())
    kk = min(k, n - 1)
    if kk < 1:
        return faults
    d2 = sqdist(h)
    d2.fill_diagonal_(math.inf)
    t = torch.kthvalue(d2, kk, dim=1).values
    sq = (h.double() ** 2).sum(-1)
    margin = tol * (sq[:, None] + sq[None, :])
    dl = d2[iota[:, None], idx]
    faults += int((valid & (dl > t[:, None] + margin[iota[:, None], idx]))
                  .sum())
    strict = d2 < t[:, None] - margin
    faults += int((strict & (listed == 0)).sum())
    return faults


def block_points(p: dict, events: Sequence[torch.Tensor],
                 lists: Sequence[Sequence[Lists]], cfg: dict,
                 prec: Precision) -> List[List[torch.Tensor]]:
    """Each event's points in each block, ``[e][b]``: (eta, phi), then the
    blocks' outputs on the given lists (what the run's lists are judged
    on)."""
    with torch.no_grad():
        sizes = [ev.shape[0] for ev in events]
        offs = [0]
        for s in sizes:
            offs.append(offs[-1] + s)
        X = torch.cat(list(events)).float()
        every = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
        x = masked_bn(p, "bn_fts", X, every)
        pts = [[points(ev.float())] for ev in events]
        for b in range(len(cfg["conv_params"]) - 1):
            idx = torch.cat([ls[b].idx.long() + o
                             for ls, o in zip(lists, offs)])
            valid = torch.cat([ls[b].valid for ls in lists])
            x = edge_conv(p, b, x, idx, valid, prec)
            for e, o in enumerate(offs[:-1]):
                pts[e].append(x[o:o + sizes[e]])
        return pts


class Batch(NamedTuple):
    """One checked step: its events' candidates, their genMET ``[E, 2]``,
    the run's lists ``[e][b]`` and dropout mask ``[E, fc]`` (or None)."""

    events: List[torch.Tensor]
    gen: torch.Tensor
    lists: List[List[Lists]]
    keep: Optional[torch.Tensor]


def train_steps(leaves: Dict[str, torch.Tensor], batches: Sequence[Batch],
                cfg: dict, optim: dict, prec: Precision = Precision(),
                tol: float = 1e-4) -> Steps:
    """ParticleNet's training steps on the run's lists and masks: the
    forward in training mode, the loss 0.5 mean |v − genMET|², the
    gradients, AdamW (reference/graphmet.py).  The faults of each step's
    lists are judged on the points the reference computes on them before
    the step (only the first step's start from the run's own
    parameters)."""
    from portbench.reference.graphmet import AdamW, trainable

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in leaves.items() if trainable(k)}
    fixed = {k: v for k, v in leaves.items() if not trainable(k)}
    opt = AdamW(params, optim["lr"], tuple(optim["betas"]), optim["eps"],
                optim["weight_decay"])
    clip = optim.get("grad_clip_norm")
    k = int(cfg["k"])
    losses, first, after, faults = [], None, [], []
    for bt in batches:
        p = {**params, **fixed}
        pts = block_points(p, bt.events, bt.lists, cfg, prec)
        faults.append(sum(check_lists(pts[e][b], bt.lists[e][b], k, tol)
                          for e in range(len(bt.events))
                          for b in range(len(cfg["conv_params"]))))
        v = forward(p, bt.events, bt.lists, bt.keep, cfg, prec)
        L = 0.5 * ((v - bt.gen) ** 2).sum(dim=1).mean()
        grads = torch.autograd.grad(L, list(params.values()))
        if clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if float(norm) >= clip:
                grads = [g / norm * clip for g in grads]
        grads = dict(zip(params, grads))
        if first is None:
            first = {kk: g.detach().clone() for kk, g in grads.items()}
        opt.step(grads)
        losses.append(float(L.detach()))
        after.append({kk: t.detach().clone() for kk, t in params.items()})
    return Steps(losses, first, after,
                 {kk: m.clone() for kk, m in opt.m.items()}, faults,
                 [0.0] * len(losses))
