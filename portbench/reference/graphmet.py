"""GraphMETNetwork in plain PyTorch, as the reference defines it
(DeepMETv2 ``model/graph_met_network.py:11-69`` and the sigmoid wrapper
``model/net.py:38-47``), with its loss (``model/net.py:49-60``) and the
AdamW step of ``torch.optim.AdamW`` written out.

Per candidate: embeddings of charge+1 [3, H/4], |pdgId| class [7, H/4] and
fromPV [8, H/4]; Linear(8, H/2)+ELU on the continuous features,
Linear(3H/4, H/2)+ELU on the embeddings, Linear(H, H)+ELU on both,
BatchNorm; ``conv_depth`` residual blocks ``x += BN(EdgeConv(x))`` whose
edge network is one Linear(2H, H) on ``[x_i, x_j - x_i]``, aggregated by
max over the radius graph in (eta, phi) (Delta R < r, no phi wrap, self
loops); head Linear(H, H/2)+ELU+Linear(H/2, 1), sigmoid.  Each edge's
message is computed as such, and the max taken over the listed edges.

A batch is its events' real candidates stacked (``Batch``), so padding
and row order play no part.  Parameters are a dict by the port's
state_dict names (``families/graphmet.py:weight_spec``).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.common import (Precision, Steps, batchnorm, elu,
                                        segment_sum)

PDGS = (1, 2, 11, 13, 22, 130, 211)


class Batch(NamedTuple):
    x: torch.Tensor        # [T, 11] the real candidates of all events
    seg: torch.Tensor      # [T] event id of each row
    y: torch.Tensor        # [E, 11]
    src: torch.Tensor      # [M] edge sources j
    dst: torch.Tensor      # [M] edge targets i (the row that aggregates)

    @property
    def n_events(self) -> int:
        return self.y.shape[0]


def etaphi(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eta, phi = atan2(py, px)) of candidate rows."""
    return x[:, 3], torch.atan2(x[:, 1], x[:, 0])


def radius_edges(eta: torch.Tensor, phi: torch.Tensor, r: float,
                 block: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) of one event's radius graph: every ordered pair with
    (eta_i - eta_j)^2 + (phi_i - phi_j)^2 < r^2, each operation rounded in
    float32, self pairs included."""
    r2 = r * r
    src, dst = [], []
    for i0 in range(0, eta.shape[0], block):
        de = eta[i0:i0 + block, None] - eta[None, :]
        dp = phi[i0:i0 + block, None] - phi[None, :]
        i, j = torch.nonzero(de * de + dp * dp < r2, as_tuple=True)
        dst.append(i + i0)
        src.append(j)
    return torch.cat(src), torch.cat(dst)


def make_batch(events: Sequence[Tuple[np.ndarray, np.ndarray]], r: float,
               device) -> Batch:
    """Stack ``(x [n, 11], y [11])`` events and build their radius graph."""
    xs, segs, srcs, dsts, off = [], [], [], [], 0
    for e, (x, _) in enumerate(events):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        eta, phi = etaphi(x)
        s, d = radius_edges(eta, phi, r)
        xs.append(x)
        segs.append(torch.full((x.shape[0],), e, dtype=torch.int64,
                               device=device))
        srcs.append(s + off)
        dsts.append(d + off)
        off += x.shape[0]
    y = torch.as_tensor(np.stack([np.asarray(y, np.float32)
                                  for _, y in events]), device=device)
    return Batch(torch.cat(xs), torch.cat(segs), y, torch.cat(srcs),
                 torch.cat(dsts))


def pdg_class(pdg: torch.Tensor) -> torch.Tensor:
    """|pdgId| -> its index in PDGS; any other id -> 0."""
    a = pdg.abs().round().long()
    out = torch.zeros_like(a)
    for k, v in enumerate(PDGS):
        out = torch.where(a == v, torch.full_like(a, k), out)
    return out


def edgeconv_max(p: dict, name: str, x: torch.Tensor, b: Batch,
                 prec: Precision) -> torch.Tensor:
    """EdgeConv with the edge network Linear(2H, H) on ``[x_i, x_j -
    x_i]`` per edge, max over each row's edges."""
    xi, xj = x[b.dst], x[b.src]
    msg = prec.linear(p, name, torch.cat([xi, xj - xi], dim=1))
    out = torch.full_like(x, -math.inf)
    return out.scatter_reduce(0, b.dst[:, None].expand_as(msg), msg, "amax",
                              include_self=False)


def forward(p: dict, b: Batch, depth: int, train: bool,
            prec: Precision = Precision()) -> torch.Tensor:
    """Per-candidate weights in (0, 1) ``[T]``."""
    x = b.x
    cat = x[:, 8:11]
    emb_cat = torch.cat([
        p["embed_charge.w"][torch.clamp(cat[:, 1].round().long() + 1, 0, 2)],
        p["embed_pdgid.w"][pdg_class(cat[:, 0])],
        p["embed_pv.w"][torch.clamp(cat[:, 2].round().long(), 0, 7)]], dim=1)
    emb_cat = elu(prec.linear(p, "embed_categorical", emb_cat))
    emb_cont = elu(prec.linear(p, "embed_continuous", x[:, :8]))
    h = elu(prec.linear(p, "encode_all", torch.cat([emb_cat, emb_cont], 1)))
    h = batchnorm(p, "bn_all", h, train)
    for d in range(depth):
        c = edgeconv_max(p, f"convs.{d}.edge", h, b, prec)
        h = h + batchnorm(p, f"convs.{d}.bn", c, train)
    out = prec.linear(p, "output.layers.1",
                      elu(prec.linear(p, "output.layers.0", h)))
    return torch.sigmoid(out[:, 0])


def met(w: torch.Tensor, b: Batch) -> torch.Tensor:
    """The MET estimate ``-sum_i w_i p_i`` per event ``[E, 2]``."""
    return -segment_sum(w[:, None] * b.x[:, :2], b.seg, b.n_events)


def loss(w: torch.Tensor, b: Batch) -> torch.Tensor:
    """0.5 * mean over events of |sum_i w_i p_i + genMET|^2."""
    s = -met(w, b)
    per = (s[:, 0] + b.y[:, 0]) ** 2 + (s[:, 1] + b.y[:, 1]) ** 2
    return 0.5 * per.mean()


class AdamW:
    """``torch.optim.AdamW``'s update written out: decoupled weight decay,
    then the bias-corrected moments."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas: Tuple[float, float], eps: float, weight_decay: float):
        self.p = params
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(leaves: Dict[str, torch.Tensor], batches: List[Batch],
                cfg: dict, prec: Precision = Precision()) -> Steps:
    """Forward, loss, backward and AdamW over ``batches`` from ``leaves``
    (``Steps``)."""
    o = cfg["optim"]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in leaves.items() if trainable(k)}
    fixed = {k: v for k, v in leaves.items() if not trainable(k)}
    opt = AdamW(params, o["lr"], tuple(o["betas"]), o["eps"],
                o["weight_decay"])
    losses, first, after = [], None, []
    depth = int(cfg["model"]["conv_depth"])
    for b in batches:
        w = forward({**params, **fixed}, b, depth, True, prec)
        L = loss(w, b)
        grads = torch.autograd.grad(L, list(params.values()))
        grads = dict(zip(params, grads))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(L.detach()))
        after.append({k: v.detach().clone() for k, v in params.items()})
    return Steps(losses, first, after,
                 {k: m.clone() for k, m in opt.m.items()}, [0] * len(losses),
                 [0.0] * len(losses))


def trainable(name: str) -> bool:
    return not name.rsplit(".", 1)[-1] in ("running_mean", "running_var",
                                           "num_batches_tracked")
