"""The DynamicReductionNetwork in plain PyTorch, in evaluation mode
(DeepMETv2 ``model/dynamic_reduction_network.py:27-103``), one event at a
time on its real candidates.

``datanorm * x`` through Linear(11, H/2), Linear(H/2, H), Linear(H, H),
each with ELU; then ``pool_rounds`` rounds of: the feature-space kNN graph
(k nearest, made undirected, each row keeping its ``cap`` nearest), the
EdgeConv whose edge network is Linear(2H, 3H/2)+ELU+Linear(3H/2, H)+ELU on
``[x_i, x_j - x_i]`` per edge with BatchNorm on the messages (running
buffers) and sum aggregation, a heavy-edge matching on normalized-cut
weights and max pooling of each matched pair; between rounds the
surviving nodes move to the front (at most 3N/4 of the padded width N,
rounded up to 128, as the port's compaction keeps them).  Then the max
over the nodes left and Linear(H, H)+ELU+Linear(H, H/2)+ELU+Linear(H/2,
2), the cartesian head scaled by ``output_scale``.

The kNN graph and the matching are discrete decisions on float32
distances, which for close candidates are mostly rounding: no two
implementations make the same ones.  So ``follow`` takes each round's
decisions (the lists and the matching) from the run being judged and
computes everything else itself.  ``check_round`` judges the lists (and
that partners are mutual, listed neighbours) against this module's own
distances in float64, and ``match_sums`` holds the matching against this
module's own on the same lists and features.  The max poolings are such
decisions for the gradient alone: at a near tie, which side (or node)
gets it is rounding.  Where the run's own pooled features are given,
``routed_pool`` and ``routed_max`` send the gradient where the run sent
it, and count as faults the choices that are wrong by more than rounding.
``own`` makes every decision itself; the benchmark counts work with it.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from portbench.reference.common import Precision, Steps, elu, segment_sum


class Lists(NamedTuple):
    """One round's neighbour lists of one event: ``idx [n, cap]`` and
    ``valid [n, cap]``, rows and indices in the round's node order."""

    idx: torch.Tensor
    valid: torch.Tensor


def compact_size(n: int) -> int:
    """The port's capacity after pooling: 3N/4 up to a multiple of 128,
    at least 128."""
    return max(128, -(-(3 * n) // (4 * 128)) * 128)


def inputnet(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    h = x * p["datanorm"]
    for i in range(3):
        h = elu(prec.linear(p, f"inputnet.layers.{i}", h))
    return h


def messages(p: dict, r: int, h: torch.Tensor, nbr: Lists,
             prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """The round's edge messages over the valid slots (j -> i), before
    the BatchNorm, and the row i of each."""
    i, k = torch.nonzero(nbr.valid, as_tuple=True)
    j = nbr.idx[i, k]
    hi = h[i]
    m = elu(prec.linear(p, f"convs.{r}.mlp.layers.0",
                        torch.cat([hi, h[j] - hi], dim=1)))
    return elu(prec.linear(p, f"convs.{r}.mlp.layers.1", m)), i


def normalize(p: dict, r: int, m: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor) -> torch.Tensor:
    bn = f"convs.{r}.bn"
    return ((m - mean) * torch.rsqrt(var + 1e-5) * p[f"{bn}.gamma"]
            + p[f"{bn}.beta"])


def conv(p: dict, r: int, h: torch.Tensor, nbr: Lists,
         prec: Precision) -> torch.Tensor:
    """The round's EdgeConv in evaluation (the running statistics), sum."""
    m, i = messages(p, r, h, nbr, prec)
    bn = f"convs.{r}.bn"
    m = normalize(p, r, m, p[f"{bn}.running_mean"], p[f"{bn}.running_var"])
    return segment_sum(m, i, h.shape[0])


def head(p: dict, h: torch.Tensor, scale: float, prec: Precision,
         g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The max over the nodes left (or ``g`` in its place), then the
    output MLP."""
    if g is None:
        g = h.max(dim=0).values if h.shape[0] else h.new_zeros(h.shape[1])
    g = elu(prec.linear(p, "output.layers.0", g))
    g = elu(prec.linear(p, "output.layers.1", g))
    return scale * prec.linear(p, "output.layers.2", g)[:2]


def pool(h: torch.Tensor, partner: torch.Tensor) -> torch.Tensor:
    """Max pooling of each matched pair onto its lower index: the
    surviving rows in ascending order."""
    iota = torch.arange(h.shape[0], device=h.device)
    rep = torch.minimum(iota, partner) == iota
    return torch.maximum(h, h[partner])[rep]


def routed_pool(h: torch.Tensor, hp: torch.Tensor, prow: torch.Tensor,
                tol: float) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Each row's max with its partner row ``prow``, the gradient going to
    the side that is larger in the run's own features ``hp`` of the same
    rows (both halves where those are equal, as ``torch.maximum``'s does).
    Returns the pooled rows, the run's pooled rows, and the faults: choices
    of a side that is smaller here by more than ``tol`` times the
    feature's largest magnitude."""
    a, b = hp, hp[prow]
    pooled = torch.where(a > b, h, torch.where(a < b, h[prow],
                                               torch.maximum(h, h[prow])))
    d = (h - h[prow]).detach()
    margin = tol * h.detach().abs().amax(dim=0)
    faults = int(((a > b) & (d < -margin)).sum()
                 + ((a < b) & (d > margin)).sum())
    return pooled, torch.maximum(a, b), faults


def routed_max(h: torch.Tensor, hp: torch.Tensor, tol: float
               ) -> Tuple[torch.Tensor, int]:
    """The max over the rows of ``h`` per feature, taken at the rows where
    the run's own ``hp`` is largest (shared evenly among equal ones, as
    ``amax``'s gradient is); faults: features whose value there is below
    this module's max by more than ``tol`` times the feature's largest
    magnitude."""
    top = hp == hp.amax(dim=0)
    g = (h * (top.to(h.dtype) / top.sum(dim=0))).sum(dim=0)
    hd = h.detach()
    faults = int((g.detach() < hd.amax(dim=0)
                  - tol * hd.abs().amax(dim=0)).sum())
    return g, faults


def sqdist(h: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ``[n, n]`` in float64, by differences."""
    h = h.double()
    return torch.cdist(h, h, compute_mode="donot_use_mm_for_euclid_dist") ** 2


def knn_lists(h: torch.Tensor, k: int, cap: int) -> Lists:
    """The undirected kNN graph of ``h``, each row its ``cap`` nearest
    members: j is a member of i where j is among i's k nearest or i among
    j's."""
    n = h.shape[0]
    d2 = sqdist(h)
    d2.fill_diagonal_(math.inf)
    kk = min(k, n - 1)
    if kk < 1:
        z = torch.zeros((n, cap), dtype=torch.int64, device=h.device)
        return Lists(z, z.bool())
    t = torch.kthvalue(d2, kk, dim=1).values
    rel = (d2 <= t[:, None]) | (d2 <= t[None, :])
    masked = torch.where(rel, d2, torch.full_like(d2, math.inf))
    c = min(cap, n - 1)
    val, idx = torch.topk(masked, c, dim=1, largest=False)
    pad = cap - c
    valid = torch.isfinite(val)
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return Lists(idx, valid)


def cut_weights(h: torch.Tensor, nbr: Lists
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized-cut weights ``|h_i - h_j| (1/deg_i + 1/deg_j)`` per
    listed slot ``[n, cap]`` (-inf at empty slots), and each weight's
    factor ``1/deg_i + 1/deg_j``."""
    deg = nbr.valid.sum(dim=1).clamp(min=1).to(h.dtype)
    c = 1 / deg[:, None] + 1 / deg[nbr.idx]
    d = (h[:, None, :] - h[nbr.idx]).pow(2).sum(-1).sqrt()
    return (torch.where(nbr.valid, d * c, torch.full_like(d, -math.inf)),
            c)


def matching(h: torch.Tensor, nbr: Lists, rounds: int = 4) -> torch.Tensor:
    """Handshake matching on normalized-cut weights (``cut_weights``):
    each unmatched node proposes to its heaviest unmatched listed
    neighbour (the first of equal ones), mutual proposals match.  Returns
    each node's partner (itself if unmatched)."""
    n = h.shape[0]
    iota = torch.arange(n, device=h.device)
    w, _ = cut_weights(h, nbr)
    matched = torch.zeros(n, dtype=torch.bool, device=h.device)
    partner = iota.clone()
    for _ in range(rounds):
        ok = nbr.valid & ~matched[nbr.idx] & ~matched[:, None]
        ww = torch.where(ok, w, torch.full_like(w, -math.inf))
        best_w, best = ww.max(dim=1)
        has = best_w > -math.inf
        prop = torch.where(has, nbr.idx[iota, best], iota)
        mutual = (prop[prop] == iota) & (prop != iota) & has & ~matched
        partner = torch.where(mutual, prop, partner)
        matched = matched | mutual
    return partner


def match_sums(h: torch.Tensor, nbr: Lists, partner: torch.Tensor,
               rounds: int = 4) -> torch.Tensor:
    """``[4]``: the nodes a matching ``partner`` (rows; itself where
    unmatched) pairs and the sum of their cut weights, then the same of
    this module's own ``matching``, all on the post-conv features ``h [n,
    H]`` in float64 and the same lists.  Near ties of the weights make two
    matchings differ in a few pairs; a matching that pairs fewer nodes
    (fewer handshake rounds, none) or lighter ones differs in the sums."""
    h = h.detach().double()
    out = torch.zeros(4, dtype=torch.float64, device=h.device)
    if h.shape[0] == 0:
        return out
    w, _ = cut_weights(h, nbr)
    iota = torch.arange(h.shape[0], device=h.device)
    for c, p in enumerate((partner, matching(h, nbr, rounds))):
        paired = p != iota
        hit = nbr.valid & (nbr.idx == p[:, None]) & paired[:, None]
        out[2 * c] = paired.sum()
        out[2 * c + 1] = torch.where(hit, w, torch.zeros_like(w)).sum()
    return out


def match_gap(sums: torch.Tensor) -> float:
    """The larger relative gap, over rounds, of the run's paired nodes and
    of their cut weight against the reference's own matching's
    (``sums [rounds, 4]`` of ``match_sums``, summed over events)."""
    run, own = sums[:, 0:2], sums[:, 2:4]
    gap = (run - own).abs() / own.clamp(min=1e-300)
    return float(gap.max()) if gap.numel() else 0.0


def check_round(h: torch.Tensor, nbr: Lists, partner: torch.Tensor, k: int,
                tol: float) -> int:
    """Faults in one round's decisions on features ``h [n, H]``: a listed
    neighbour that is neither within i's k-th distance nor i within its
    own, past ``tol (|h_i|^2 + |h_j|^2)``; one of i's k nearest (closer
    than its k-th distance by that margin) missing from i's list; a slot
    at i itself or outside the event; a partner that is not mutual or not
    listed both ways."""
    n = h.shape[0]
    if n == 0:
        return 0
    iota = torch.arange(n, device=h.device)
    idx = nbr.idx.clamp(0, max(n - 1, 0))
    faults = int((nbr.valid & ((nbr.idx < 0) | (nbr.idx >= n)
                               | (nbr.idx == iota[:, None]))).sum())
    d2 = sqdist(h)
    d2.fill_diagonal_(math.inf)
    kk = min(k, n - 1)
    if kk >= 1:
        t = torch.kthvalue(d2, kk, dim=1).values
        sq = (h.double() ** 2).sum(-1)
        margin = tol * (sq[:, None] + sq[None, :])
        dl = d2[iota[:, None], idx]
        ml = margin[iota[:, None], idx]
        member = (dl <= t[:, None] + ml) | (dl <= t[idx] + ml)
        faults += int((nbr.valid & ~member).sum())
        listed = torch.zeros((n, n), dtype=torch.bool, device=h.device)
        listed[iota[:, None].expand_as(idx)[nbr.valid], idx[nbr.valid]] = True
        strict = d2 < t[:, None] - margin
        faults += int((strict & ~listed).sum())
    bad = (partner < 0) | (partner >= n)
    faults += int(bad.sum())
    p = partner.clamp(0, n - 1)
    moved = (p != iota) & ~bad
    faults += int((moved & (p[p] != iota)).sum())
    if kk >= 1:
        near = d2[iota, p] <= torch.maximum(t, t[p]) + margin[iota, p]
        faults += int((moved & ~near).sum())
    return faults


class Event(NamedTuple):
    x: torch.Tensor        # [n, 11] real candidates
    width: int             # the padded node width of the event's batch


class Decisions(NamedTuple):
    """One event's decisions in one round, from the run being judged:
    the round's node mask (to check), lists and matching, in the round's
    padded node order, and where recorded the run's features that the
    round's pooling compares (``routed_pool``)."""

    mask: torch.Tensor     # [N_r] bool
    lists: Lists           # [N_r, cap]
    cluster: torch.Tensor  # [N_r]
    partner: torch.Tensor  # [N_r]
    feats: Optional[torch.Tensor] = None  # [N_r, H]


def _decode(dec: Decisions, pos: torch.Tensor, k: int, h: torch.Tensor,
            tol: float):
    """One round's decisions in the round's real rows: the lists, each
    row's partner row, and the faults found in them."""
    width = dec.mask.shape[0]
    n = pos.shape[0]
    want = torch.zeros_like(dec.mask)
    want[pos] = True
    faults = int((dec.mask != want).sum())
    row = torch.full((width,), -1, dtype=torch.int64, device=pos.device)
    row[pos] = torch.arange(n, device=pos.device)
    idx = dec.lists.idx[pos].long()
    inside = (idx >= 0) & (idx < width)
    j = torch.where(inside, row[idx.clamp(0, width - 1)],
                    torch.full_like(idx, -1))
    valid = dec.lists.valid[pos]
    faults += int((valid & (j < 0)).sum())
    nbr = Lists(j.clamp(min=0), valid & (j >= 0))
    ppos = dec.partner[pos].long()
    pin = (ppos >= 0) & (ppos < width)
    prow = torch.where(pin, row[ppos.clamp(0, width - 1)],
                       torch.full_like(ppos, -1))
    faults += int((prow < 0).sum())
    prow = torch.where(prow < 0, torch.arange(n, device=pos.device), prow)
    faults += int((dec.cluster[pos].long()
                   != torch.minimum(pos, ppos)).sum())
    faults += check_round(h.detach(), nbr, prow, k, tol)
    return nbr, prow, faults


def follow_batch(p: dict, events: List[Event],
                 rounds: List[List[Decisions]], cfg: dict, prec: Precision,
                 tol: float, train: bool
                 ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """The events' MET ``[E, 2]`` on the given decisions (``rounds[e]``
    for event e), the faults found in them, and each round's
    ``match_sums`` over the events ``[rounds, 4]``.  ``train``: each round's
    BatchNorm normalizes with the biased statistics of all the batch's
    edge messages, as a training step does; otherwise the running ones.
    ``pos`` holds the padded position of each real row of a round; ``run``
    the run's pooled rows, where its features were recorded, which route
    the poolings' gradients (``routed_pool``, ``routed_max``)."""
    k, compact = int(cfg["k"]), bool(cfg["compact_pool"])
    hs = [inputnet(p, ev.x, prec) for ev in events]
    poss = [torch.arange(h.shape[0], device=h.device) for h in hs]
    run: List[Optional[torch.Tensor]] = [None] * len(events)
    faults = 0
    sums = torch.zeros((len(rounds[0]), 4), dtype=torch.float64,
                       device=hs[0].device)
    for r in range(len(rounds[0])):
        parts = []
        for e, (h, pos) in enumerate(zip(hs, poss)):
            nbr, prow, f = _decode(rounds[e][r], pos, k, h, tol)
            faults += f
            parts.append((*messages(p, r, h, nbr, prec), nbr, prow))
        if train:
            allm = torch.cat([part[0] for part in parts])
            mean = allm.mean(dim=0)
            var = ((allm - mean) ** 2).mean(dim=0)
        else:
            bn = f"convs.{r}.bn"
            mean, var = p[f"{bn}.running_mean"], p[f"{bn}.running_var"]
        for e, (m, i, nbr, prow) in enumerate(parts):
            h = segment_sum(normalize(p, r, m, mean, var), i,
                            hs[e].shape[0])
            sums[r] += match_sums(h, nbr, prow)
            pos, dec = poss[e], rounds[e][r]
            rep = torch.minimum(pos, pos[prow]) == pos
            if dec.feats is None:
                pooled, run[e] = torch.maximum(h, h[prow]), None
            else:
                pooled, hp, f = routed_pool(h, dec.feats[pos].to(h.dtype),
                                            prow, tol)
                faults += f
                run[e] = hp[rep]
            hs[e], poss[e] = pooled[rep], pos[rep]
            width = dec.mask.shape[0]
            if (compact and r < len(rounds[e]) - 1
                    and compact_size(width) < width):
                hs[e] = hs[e][:compact_size(width)]
                poss[e] = torch.arange(hs[e].shape[0], device=h.device)
                if run[e] is not None:
                    run[e] = run[e][:compact_size(width)]
    outs = []
    for h, hp in zip(hs, run):
        g = None
        if hp is not None and h.shape[0]:
            g, f = routed_max(h, hp, tol)
            faults += f
        outs.append(head(p, h, float(cfg["output_scale"]), prec, g))
    return torch.stack(outs), faults, sums


def follow(p: dict, ev: Event, rounds: List[Decisions], cfg: dict,
           prec: Precision, tol: float
           ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """``follow_batch`` in evaluation for one event: its MET ``[2]``."""
    out, faults, sums = follow_batch(p, [ev], [rounds], cfg, prec, tol,
                                     False)
    return out[0], faults, sums


def train_steps(leaves: Dict[str, torch.Tensor], batches, decisions,
                cfg: dict, prec: Precision = Precision(),
                tol: float = 1e-4) -> Steps:
    """The DRN's training steps on the given decisions: forward with the
    batch's BatchNorm statistics, the loss 0.5 mean |v - genMET|^2, the
    gradients clipped to the global norm ``grad_clip_norm`` (optax's
    rule), the AdamW step of reference/graphmet.py.  ``batches``: per
    step, its events and their ``[E, 2]`` genMET; ``decisions``: per step,
    per event, its rounds.  Returns ``Steps`` (the first gradient clipped):
    only the first step's decisions are judged on the parameters they were
    made with, the later steps' on the reference's own, so only the first
    step's faults and matching gap are the run's."""
    from portbench.reference.graphmet import AdamW, trainable

    o, d = cfg["optim"], cfg["drn"]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in leaves.items() if trainable(k)}
    fixed = {k: v for k, v in leaves.items() if not trainable(k)}
    opt = AdamW(params, o["lr"], tuple(o["betas"]), o["eps"],
                o["weight_decay"])
    clip = o["grad_clip_norm"]
    losses, first, after, faults, match = [], None, [], [], []
    for (events, gen), dec in zip(batches, decisions):
        v, f, sums = follow_batch({**params, **fixed}, events, dec, d, prec,
                                  tol, True)
        faults.append(f)
        match.append(match_gap(sums))
        L = 0.5 * ((v - gen) ** 2).sum(dim=1).mean()
        grads = torch.autograd.grad(L, list(params.values()))
        if clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if float(norm) >= clip:
                grads = [g / norm * clip for g in grads]
        grads = dict(zip(params, grads))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(L.detach()))
        after.append({k: v.detach().clone() for k, v in params.items()})
    return Steps(losses, first, after,
                 {k: m.clone() for k, m in opt.m.items()}, faults, match)


def own(p: dict, ev: Event, cfg: dict, prec: Precision = Precision()
        ) -> Tuple[torch.Tensor, List[Dict[str, int]]]:
    """The event's MET ``[2]`` on decisions of its own, and each round's
    work: real nodes ``n``, listed edges ``edges``, padded width ``width``."""
    k = int(cfg["k"])
    cap = int(cfg["und_cap"] or 2 * k)
    rounds = int(cfg["pool_rounds"])
    h, width, work = inputnet(p, ev.x, prec), ev.width, []
    for r in range(rounds):
        nbr = knn_lists(h, k, cap)
        work.append({"n": h.shape[0], "edges": int(nbr.valid.sum()),
                     "width": width})
        h = conv(p, r, h, nbr, prec)
        h = pool(h, matching(h, nbr))
        if (cfg["compact_pool"] and r < rounds - 1
                and compact_size(width) < width):
            width = compact_size(width)
            h = h[:width]
    return head(p, h, float(cfg["output_scale"]), prec), work
