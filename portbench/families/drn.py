"""The DynamicReductionNetwork (``models.drn.DRN``): its leaves and input
scale, its training and evaluation steps as the entries drive them, their
checks against the plain reference (``reference/drn.py``) on the graph
decisions the run made (``record.py``), the bounds and operations of its
kernels (``counts/``), and the faults that only its paths have.

The control is the reference with every product's operands rounded to
TF32, computed in the program's place.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from portbench import cell, faults, record, tracing, weights
from portbench.counts import edge_mlp, knn, peaks
from portbench.counts import model as model_counts
from portbench.reference import drn as ref
from portbench.reference.common import Precision


def weight_spec(drn: dict) -> weights.Spec:
    """The DynamicReductionNetwork's leaves for the config's ``drn``
    section; ``datanorm`` is given by the caller."""
    H, F = int(drn["hidden_dim"]), int(drn["input_dim"])
    spec: weights.Spec = [("datanorm", (F,), "given", 0.0)]
    for i, (a, b) in enumerate(((F, H // 2), (H // 2, H), (H, H))):
        weights.linear(spec, f"inputnet.layers.{i}", a, b)
    for i, (a, b) in enumerate(((H, H), (H, H // 2),
                                (H // 2, int(drn["output_dim"])))):
        weights.linear(spec, f"output.layers.{i}", a, b)
    for r in range(int(drn["pool_rounds"])):
        weights.linear(spec, f"convs.{r}.mlp.layers.0", 2 * H, 3 * H // 2)
        weights.linear(spec, f"convs.{r}.mlp.layers.1", 3 * H // 2, H)
        weights.bn(spec, f"convs.{r}.bn", H)
    return spec


def datanorm(events) -> list:
    """The input scale: 1/std of each feature over the events' candidates
    (1 where the std is under 1e-6), as the train CLI derives it
    (``cli/train.py:drn_data_init``)."""
    x = np.concatenate([e[0] for e in events]).astype(np.float64)
    std = x.std(axis=0)
    return list(1.0 / np.where(std > 1e-6, std, 1.0))


def make_leaves(r: cell.Run, events) -> Dict[str, torch.Tensor]:
    return weights.make(weight_spec(r.spec.config["drn"]), r.seed, r.device,
                        {"datanorm": datanorm(events)})


class Train:
    """Batches as collated, datanorm from the training events (as the
    train CLI sets it), the kNN and edge-MLP kernels; the reference
    follows the decisions the port's checked steps made."""

    name = "drn"

    def __init__(self, r: cell.Run, events):
        from deepmetv2_tpu_torch.data.loader import METDataset, PaddedLoader
        from deepmetv2_tpu_torch.models.drn import DRN

        self.r, cfgj, t = r, r.spec.config, r.spec.traffic
        self.loader = PaddedLoader(
            METDataset(events=events), np.arange(len(events)),
            int(t["batch"]), tuple(cfgj["data"]["node_buckets"]),
            "sequential")
        self.cfg = cell.port_config(cfgj, data={"batch_size": int(t["batch"])})
        self.leaves = make_leaves(r, events)
        self.model = DRN(self.cfg.drn, device=r.device)
        self.model.load_state_dict(self.leaves)
        self.leaves = weights.clone(self.leaves)

    def watch(self, n: int) -> None:
        """Record the decisions of the first ``n`` forwards, and the
        features the first one's poolings compare (its gradient is the
        first step's)."""
        self.recorder = record.Recorder(self.cfg.drn.pool_rounds, n, feats=1)

    def reference(self, batches):
        """The reference's steps on the recorded decisions (and, for the
        control, the same in TF32 in the program's place)."""
        rec, dev = self.recorder, self.r.device
        rec.restore()
        steps, decisions = [], []
        for s, evs in enumerate(batches):
            width = rec.width(s)
            steps.append(([ref.Event(torch.as_tensor(x, device=dev), width)
                           for x, _ in evs],
                          torch.as_tensor(np.stack([y[:2] for _, y in evs]),
                                          device=dev)))
            decisions.append([rec.decisions(s, i, dev)
                              for i in range(len(evs))])
        tol = float(self.r.spec.limits["knn_tol"])
        cfgj = self.r.spec.config
        got = ref.train_steps(self.leaves, steps, decisions, cfgj,
                              Precision(), tol)
        control = (ref.train_steps(self.leaves, steps, decisions, cfgj,
                                   Precision(tf32=True), tol)
                   if self.r.control else None)
        return got, control

    def counts(self, host_batches) -> tuple:
        d = self.r.spec.config["drn"]
        H, F = int(d["hidden_dim"]), int(d["input_dim"])
        F1, cap = 3 * H // 2, int(d["und_cap"] or 2 * int(d["k"]))
        bound = ops = 0.0
        for b in host_batches:
            mask = np.asarray(b.mask)
            Bb, N = mask.shape
            x = np.concatenate([np.asarray(b.x_cont),
                                np.asarray(b.x_cat, np.float32)], -1)
            work = [ref.own(self.leaves, ref.Event(torch.as_tensor(
                x[e][mask[e]], device=self.r.device), N), d)[1]
                for e in range(Bb) if mask[e].any()]
            ops += model_counts.drn_train_ops(work, F, H,
                                              int(d["output_dim"]))
            for rnd in range(len(work[0])):
                ns = [w[rnd]["n"] for w in work]
                E = sum(w[rnd]["edges"] for w in work)
                Nr, n = work[0][rnd]["width"], sum(ns)
                kops = knn.ops(ns, H)
                nb = edge_mlp.nbytes(n, Bb, Nr, cap, H, F1, H)
                bound += (peaks.bound_s(knn.nbytes(ns, Bb, Nr, H), kops)
                          + peaks.bound_s(knn.nbytes(ns, Bb, Nr, H, cap), kops)
                          + peaks.bound_s(nb, edge_mlp.kernel_ops(
                              n, E, H, F1, H))
                          + peaks.bound_s(2 * nb, edge_mlp.bwd_ops(
                              n, E, H, F1, H)))
        return bound, ops


class Serve:
    """The evaluation step (``train.step.make_drn_eval_step``: the kNN and
    edge-MLP kernels, the matching); the graph decisions of the sampled
    batches are recorded for the check (record.py)."""

    def __init__(self, r: cell.Run, events):
        from deepmetv2_tpu_torch.models.drn import DRN
        from deepmetv2_tpu_torch.train.step import make_drn_eval_step

        self.r = r
        self.cfg = cell.port_config(r.spec.config)
        leaves = make_leaves(r, events)
        self.model = DRN(self.cfg.drn, device=r.device)
        self.model.load_state_dict(leaves)
        self.leaves = weights.clone(leaves)
        self.eval_step = make_drn_eval_step(self.cfg)

    def step(self, batch, keep: bool):
        rec = record.Recorder(self.cfg.drn.pool_rounds) if keep else None
        v_met, _, _ = self.eval_step(self.model, batch)
        with tracing.span("fetch"):
            return v_met.cpu().numpy(), None, rec

    def release(self) -> None:
        del self.model, self.eval_step

    def check(self, kept) -> Dict[str, float]:
        dcfg = self.r.spec.config["drn"]
        tol = float(self.r.spec.limits["knn_tol"])
        dev = self.r.device
        port, want, wrong, sums = [], [], 0, 0
        for evs, met, _, rec in kept:
            for i, (x, _) in enumerate(evs):
                dec = rec.decisions(0, i, dev)
                ev = ref.Event(torch.as_tensor(x, device=dev), rec.width(0))
                v, f, s = ref.follow(self.leaves, ev, dec, dcfg, Precision(),
                                     tol)
                wrong, sums = wrong + f, sums + s
                want.append(v.cpu().numpy())
                if self.r.control:
                    v = ref.follow(self.leaves, ev, dec, dcfg,
                                   Precision(tf32=True), tol)[0]
                    port.append(v.cpu().numpy())
                else:
                    port.append(met[i])
        return {"met_rel": cell.met_rel(np.stack(port), np.stack(want)),
                "graph_faults": float(wrong),
                "match_gap": ref.match_gap(sums)}

    def counts(self, batches, widths) -> tuple:
        dcfg = self.r.spec.config["drn"]
        H, F = int(dcfg["hidden_dim"]), int(dcfg["input_dim"])
        cap = int(dcfg["und_cap"] or 2 * int(dcfg["k"]))
        B = int(self.r.spec.traffic["batch"])
        bound = ops = 0.0
        memo: dict = {}
        for evs, N in zip(batches, widths):
            if id(evs) not in memo:
                memo[id(evs)] = [ref.own(self.leaves, ref.Event(
                    torch.as_tensor(x, device=self.r.device), N), dcfg)[1]
                    for x, _ in evs]
            work = memo[id(evs)]
            ops += model_counts.drn_infer_ops(work, F, H,
                                              int(dcfg["output_dim"]))
            for rnd in range(len(work[0])):
                ns = [w[rnd]["n"] for w in work]
                E = sum(w[rnd]["edges"] for w in work)
                Nr = work[0][rnd]["width"]
                kops = knn.ops(ns, H)
                bound += peaks.bound_s(knn.nbytes(ns, B, Nr, H), kops)
                bound += peaks.bound_s(knn.nbytes(ns, B, Nr, H, cap), kops)
                bound += peaks.bound_s(
                    edge_mlp.nbytes(sum(ns), B, Nr, cap, H, 3 * H // 2, H),
                    edge_mlp.kernel_ops(sum(ns), E, H, 3 * H // 2, H))
        return bound, ops


@contextlib.contextmanager
def _half_batch():
    """The training loss and the evaluation MET over the first half of
    each batch's events."""
    from deepmetv2_tpu_torch.train import loss as port_loss
    from deepmetv2_tpu_torch.train import step as port_step

    drn_loss, drn_met = port_step.drn_loss_fn, port_loss.drn_met_vector

    def half_drn(pred, head="polar"):
        v = drn_met(pred, head)
        keep = torch.arange(v.shape[0], device=v.device) < (
            v.shape[0] + 1) // 2
        return torch.where(keep[:, None], v, torch.zeros_like(v))

    with faults.patched(port_step, "drn_loss_fn",
                        lambda p, b, head="polar": drn_loss(
                            p, faults.first_half(b), head)), \
            faults.patched(port_loss, "drn_met_vector", half_drn), \
            faults.patched(port_step, "drn_met_vector", half_drn):
        yield


@contextlib.contextmanager
def _altered():
    """The first event's MET of every evaluated batch made 1 % larger."""
    from deepmetv2_tpu_torch.train import loss as port_loss
    from deepmetv2_tpu_torch.train import step as port_step

    drn_met = port_loss.drn_met_vector

    def bumped(p, head="polar"):
        return faults.bump(drn_met(p, head))

    with faults.patched(port_loss, "drn_met_vector", bumped), \
            faults.patched(port_step, "drn_met_vector", bumped):
        yield


@contextlib.contextmanager
def _no_matching():
    """The matching pairs no node: each is its own partner and cluster."""
    from deepmetv2_tpu_torch.models import drn as port_drn

    def unmatched(g, h, mask, *a, **k):
        B, N = mask.shape
        iota = torch.arange(N, device=mask.device).expand(B, N)
        return iota.clone(), iota.clone()

    with faults.patched(port_drn, "cut_matching", unmatched):
        yield


FAULTS = {"half_batch": _half_batch, "altered": _altered,
          "no_matching": _no_matching}
