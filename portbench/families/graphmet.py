"""GraphMET (``models.graph_met.GraphMET``): its leaves, its training and
evaluation steps as the entries drive them, their checks against the plain
reference (``reference/graphmet.py``), the bounds and operations of their
kernels (``counts/``), and the faults that only its paths have.

The radius graph is rebuilt by the reference from the events, so nothing
of the port's graph is recorded.  The control is the port's own bfloat16
path (``model.compute_dtype``), so the reference never runs in its place.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from portbench import cell, faults, tracing, weights
from portbench.counts import peaks, window
from portbench.counts import model as model_counts
from portbench.reference import graphmet as ref


def weight_spec(model: dict) -> weights.Spec:
    """GraphMETNetwork's leaves for the config's ``model`` section."""
    H, spec = int(model["hidden_dim"]), []
    for name, vocab in (("embed_charge", 3), ("embed_pdgid", 7),
                        ("embed_pv", 8)):
        spec.append((f"{name}.w", (vocab, H // 4), "normal", 1.0))
    weights.linear(spec, "embed_continuous", int(model["continuous_dim"]),
                   H // 2)
    weights.linear(spec, "embed_categorical", 3 * H // 4, H // 2)
    weights.linear(spec, "encode_all", H, H)
    weights.bn(spec, "bn_all", H)
    for d in range(int(model["conv_depth"])):
        weights.linear(spec, f"convs.{d}.edge", 2 * H, H)
        weights.bn(spec, f"convs.{d}.bn", H)
    weights.linear(spec, "output.layers.0", H, H // 2)
    weights.linear(spec, "output.layers.1", H // 2, int(model["output_dim"]))
    return spec


def precision(r: cell.Run) -> dict:
    """The ``model`` section's override of a run: the bfloat16 path for
    the control."""
    return {"compute_dtype": "bfloat16"} if r.control else {}


class Train:
    """Batches presorted on the host in cell order (the halo sized from
    them, as the train CLI does), the window kernels."""

    name = "graphmet"

    def __init__(self, r: cell.Run, events):
        from deepmetv2_tpu_torch.data.loader import METDataset, PaddedLoader
        from deepmetv2_tpu_torch.models.graph_met import GraphMET

        self.r, cfgj, t = r, r.spec.config, r.spec.traffic
        self.radius = float(cfgj["graph"]["delta_r"])
        self.loader = PaddedLoader(
            METDataset(events=events), np.arange(len(events)),
            int(t["batch"]), tuple(cfgj["data"]["node_buckets"]),
            "sequential", presort_eta=True, presort_mode=t["presort"],
            presort_r=self.radius)
        halo = cell.round_halo(self.loader.required_halo(self.radius))
        self.cfg = cell.port_config(cfgj, graph={
            "mode": "window", "window_halo": halo, "presorted": True},
            model=precision(r))
        self.leaves = weights.make(weight_spec(cfgj["model"]), r.seed,
                                   r.device)
        self.model = GraphMET(self.cfg.model, device=r.device)
        self.model.load_state_dict(self.leaves)
        self.leaves = weights.clone(self.leaves)

    def watch(self, n: int) -> None:
        """Nothing to record: the reference builds the radius graph
        itself."""

    def reference(self, batches):
        """The reference's steps (the control is the port's own bfloat16
        path, so none in its place)."""
        check = [ref.make_batch(evs, self.radius, self.r.device)
                 for evs in batches]
        return ref.train_steps(self.leaves, check, self.r.spec.config), None

    def counts(self, host_batches) -> tuple:
        cfgj = self.r.spec.config
        H = int(cfgj["model"]["hidden_dim"])
        depth = int(cfgj["model"]["conv_depth"])
        bound = ops = 0.0
        for b in host_batches:
            mask = np.asarray(b.mask)
            Bb, N = mask.shape
            real = int(mask.sum())
            edges = radius_edge_count(b, self.radius, self.r.device)
            bound += depth * (
                peaks.bound_s(window.nbytes(real, Bb, N, H, 1),
                              window.fwd_ops(edges, H))
                + peaks.bound_s(window.nbytes(real, Bb, N, H, 3),
                                window.bwd_ops(edges, H)))
            ops += model_counts.graphmet_ops(real, edges, H, depth, True)
        return bound, ops


class Serve:
    """The evaluation step (``train.step.make_eval_step``: the eta sort on
    the card, the window kernels), its check and its counts."""

    def __init__(self, r: cell.Run, events):
        from deepmetv2_tpu_torch.data.sorting import required_halo_events
        from deepmetv2_tpu_torch.models.graph_met import GraphMET
        from deepmetv2_tpu_torch.train.step import make_eval_step

        self.r, cfgj = r, r.spec.config
        self.radius = float(cfgj["graph"]["delta_r"])
        halo = cell.round_halo(required_halo_events(events, self.radius))
        self.cfg = cell.port_config(cfgj, graph={
            "mode": "window", "window_halo": halo, "presorted": False},
            model=precision(r))
        leaves = weights.make(weight_spec(cfgj["model"]), r.seed, r.device)
        self.model = GraphMET(self.cfg.model, device=r.device)
        self.model.load_state_dict(leaves)
        self.leaves = weights.clone(leaves)
        self.eval_step = make_eval_step(self.cfg)

    def step(self, batch, keep: bool):
        v_met, _, w = self.eval_step(self.model, batch)
        with tracing.span("fetch"):
            return v_met.cpu().numpy(), w.cpu().numpy(), None

    def release(self) -> None:
        del self.model, self.eval_step

    def check(self, kept) -> Dict[str, float]:
        mets, ws = [], []
        depth = int(self.r.spec.config["model"]["conv_depth"])
        for evs, met, w, _ in kept:
            b = ref.make_batch(evs, self.radius, self.r.device)
            wr = ref.forward(self.leaves, b, depth, False)
            mets.append((met[:len(evs)], ref.met(wr, b).cpu().numpy()))
            wp = np.concatenate([w[i, :len(x)] for i, (x, _) in
                                 enumerate(evs)])
            ws.append(float(np.abs(wp - wr.cpu().numpy()).max()))
        port = np.concatenate([m[0] for m in mets])
        want = np.concatenate([m[1] for m in mets])
        return {"met_rel": cell.met_rel(port, want), "w_abs": max(ws)}

    def counts(self, batches, widths) -> tuple:
        H = int(self.r.spec.config["model"]["hidden_dim"])
        depth = int(self.r.spec.config["model"]["conv_depth"])
        B = int(self.r.spec.traffic["batch"])
        bound = ops = 0.0
        memo: dict = {}
        for evs, N in zip(batches, widths):
            real = sum(len(x) for x, _ in evs)
            if id(evs) not in memo:
                memo[id(evs)] = sum(ref.radius_edges(
                    *ref.etaphi(torch.as_tensor(x, device=self.r.device)),
                    self.radius)[0].numel() for x, _ in evs)
            edges = memo[id(evs)]
            bound += depth * peaks.bound_s(window.nbytes(real, B, N, H, 1),
                                           window.fwd_ops(edges, H))
            ops += model_counts.graphmet_ops(real, edges, H, depth, False)
        return bound, ops


def radius_edge_count(b, radius: float, dev) -> int:
    """Directed radius-graph pairs (self included) of a host batch's real
    candidates."""
    total = 0
    x = torch.as_tensor(np.asarray(b.x_cont), device=dev)
    for e, m in enumerate(np.asarray(b.mask)):
        if m.any():
            rows = x[e][torch.as_tensor(m, device=dev)]
            total += int(ref.radius_edges(*ref.etaphi(rows),
                                          radius)[0].numel())
    return total


@contextlib.contextmanager
def _half_batch():
    """The training loss and the evaluation MET over the first half of
    each batch's events."""
    from deepmetv2_tpu_torch.train import step as port_step

    loss_fn, neg_met = port_step.loss_fn, port_step._neg_weighted_met

    def half_met(w, batch):
        v = neg_met(w, batch)
        return torch.where((faults.first_half(batch).num_valid > 0)[:, None],
                           v, torch.zeros_like(v))

    with faults.patched(port_step, "loss_fn",
                        lambda w, b: loss_fn(w, faults.first_half(b))), \
            faults.patched(port_step, "_neg_weighted_met", half_met):
        yield


@contextlib.contextmanager
def _altered():
    """The first event's MET of every evaluated batch made 1 % larger."""
    from deepmetv2_tpu_torch.train import step as port_step

    neg_met = port_step._neg_weighted_met
    with faults.patched(port_step, "_neg_weighted_met",
                        lambda w, b: faults.bump(neg_met(w, b))):
        yield


FAULTS = {"half_batch": _half_batch, "altered": _altered}
