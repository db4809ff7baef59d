"""The inference entry: batches of new events through the port's
evaluation step, closed loop, as ``cli.predict`` serves them.

A pool of events is cycled through in batches of ``batch``; every batch
is collated anew on the host (``data.batching.collate``, the memo of
``data/loader.py`` would hide work a deployment does for every new
event), copied to the card (``to_device``), run through the family's
evaluation step, and its MET (and GraphMET's per-candidate weights, which
``cli.predict`` writes) copied back to the host.  A batch's latency runs
from the start of its collation until its outputs are on the host.

Set-up warms each padded shape the pool's batches take, twice.  Batches at
positions drawn from the seed (``sample_batches`` of the first
``sample_from``) are kept and judged against the plain reference once the
window has closed.  A ``--trace 1`` run traces ``trace_seconds`` of
batches instead of the window.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import numpy as np
import torch

from portbench import cell, record, tracing, weights
from portbench.counts import edge_mlp, knn, peaks, window
from portbench.counts import model as model_counts
from portbench.gen import events as gen
from portbench.reference import drn as ref_drn
from portbench.reference import graphmet as ref_gm
from portbench.reference.common import Precision


def met_rel(port: np.ndarray, ref: np.ndarray) -> float:
    """The largest gap of an event's MET vector, over the larger of its
    reference length and the median event's."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    size = np.hypot(ref[:, 0], ref[:, 1])
    scale = np.maximum(size, np.median(size))
    gap = np.hypot(*(port - ref).T)
    bad = ~np.isfinite(gap)
    return float("inf") if bad.any() else float((gap / scale).max())


class GraphMETServe:
    """GraphMET's evaluation step (``train.step.make_eval_step``: the eta
    sort on the card, the window kernels), its check and its counts."""

    def __init__(self, r: cell.Run, events):
        from deepmetv2_tpu_torch.data.sorting import required_halo_events
        from deepmetv2_tpu_torch.models.graph_met import GraphMET
        from deepmetv2_tpu_torch.train.step import make_eval_step

        self.r, cfgj = r, r.spec.config
        self.radius = float(cfgj["graph"]["delta_r"])
        halo = cell.round_halo(required_halo_events(events, self.radius))
        over = {"compute_dtype": "bfloat16"} if r.control else {}
        self.cfg = cell.port_config(cfgj, graph={
            "mode": "window", "window_halo": halo, "presorted": False},
            model=over)
        leaves = weights.make(weights.graphmet_spec(cfgj["model"]), r.seed,
                              r.device)
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
            b = ref_gm.make_batch(evs, self.radius, self.r.device)
            wr = ref_gm.forward(self.leaves, b, depth, False)
            mets.append((met[:len(evs)], ref_gm.met(wr, b).cpu().numpy()))
            wp = np.concatenate([w[i, :len(x)] for i, (x, _) in
                                 enumerate(evs)])
            ws.append(float(np.abs(wp - wr.cpu().numpy()).max()))
        port = np.concatenate([m[0] for m in mets])
        ref = np.concatenate([m[1] for m in mets])
        return {"met_rel": met_rel(port, ref), "w_abs": max(ws)}

    def counts(self, batches, widths) -> tuple:
        H = int(self.r.spec.config["model"]["hidden_dim"])
        depth = int(self.r.spec.config["model"]["conv_depth"])
        B = int(self.r.spec.traffic["batch"])
        bound = ops = 0.0
        memo: dict = {}
        for evs, N in zip(batches, widths):
            real = sum(len(x) for x, _ in evs)
            if id(evs) not in memo:
                memo[id(evs)] = sum(ref_gm.radius_edges(
                    *ref_gm.etaphi(torch.as_tensor(x, device=self.r.device)),
                    self.radius)[0].numel() for x, _ in evs)
            edges = memo[id(evs)]
            bound += depth * peaks.bound_s(window.nbytes(real, B, N, H, 1),
                                           window.fwd_ops(edges, H))
            ops += model_counts.graphmet_ops(real, edges, H, depth, False)
        return bound, ops


class DRNServe:
    """The DRN's evaluation step (``train.step.make_drn_eval_step``: the
    kNN and edge-MLP kernels, the matching); the graph decisions of the
    sampled batches are recorded for the check (record.py)."""

    def __init__(self, r: cell.Run, events):
        from deepmetv2_tpu_torch.models.drn import DRN
        from deepmetv2_tpu_torch.train.step import make_drn_eval_step

        self.r, cfgj = r, r.spec.config
        self.cfg = cell.port_config(cfgj)
        leaves = weights.make(weights.drn_spec(cfgj["drn"]), r.seed,
                              r.device,
                              {"datanorm": weights.drn_datanorm(events)})
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
        port, ref, faults, sums = [], [], 0, 0
        for evs, met, _, rec in kept:
            for i, (x, _) in enumerate(evs):
                dec = rec.decisions(0, i, dev)
                ev = ref_drn.Event(torch.as_tensor(x, device=dev),
                                   rec.width(0))
                v, f, s = ref_drn.follow(self.leaves, ev, dec, dcfg,
                                         Precision(), tol)
                faults, sums = faults + f, sums + s
                ref.append(v.cpu().numpy())
                if self.r.control:
                    v = ref_drn.follow(self.leaves, ev, dec, dcfg,
                                       Precision(tf32=True), tol)[0]
                    port.append(v.cpu().numpy())
                else:
                    port.append(met[i])
        return {"met_rel": met_rel(np.stack(port), np.stack(ref)),
                "graph_faults": float(faults),
                "match_gap": ref_drn.match_gap(sums)}

    def counts(self, batches, widths) -> tuple:
        dcfg = self.r.spec.config["drn"]
        H, F = int(dcfg["hidden_dim"]), int(dcfg["input_dim"])
        cap = int(dcfg["und_cap"] or 2 * int(dcfg["k"]))
        B = int(self.r.spec.traffic["batch"])
        bound = ops = 0.0
        memo: dict = {}
        for evs, N in zip(batches, widths):
            if id(evs) not in memo:
                memo[id(evs)] = [ref_drn.own(self.leaves, ref_drn.Event(
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


FAMILIES = {"graphmet": GraphMETServe, "drn": DRNServe}


def sample_positions(t: dict, seed: int) -> set:
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    n = min(int(t["sample_batches"]), int(t["sample_from"]))
    return set(int(i) for i in rng.choice(int(t["sample_from"]), n,
                                          replace=False))


def run(r: cell.Run) -> cell.Outcome:
    from deepmetv2_tpu_torch.data.batching import (bucket_for, collate,
                                                   to_device)

    cfgj, t, dev = r.spec.config, r.spec.traffic, r.device
    reading = cell.Reading(entry="infer")
    B = int(t["batch"])
    buckets = tuple(cfgj["data"]["node_buckets"])
    events = gen.make_events(t, r.seed)
    pool = gen.batches(events, B)
    fam = FAMILIES[cfgj["family"]](r, events)
    widths = [bucket_for(max(len(x) for x, _ in evs), buckets)
              for evs in pool]

    def one(i: int, keep: bool):
        evs = pool[i % len(pool)]
        t0 = time.perf_counter()
        with tracing.span("collate"):
            host = collate(evs, buckets=buckets, pad_events_to=B)
        t1 = time.perf_counter()
        with tracing.span("to_device"):
            batch = to_device(host, dev)
        with tracing.span("step"):
            met, w, extra = fam.step(batch, keep)
        t2 = time.perf_counter()
        return t1 - t0, t2 - t0, (evs, met, w, extra)

    for N in sorted(set(widths)):             # every shape, twice
        first = widths.index(N)
        one(first, False)
        one(first, False)
    cell.sync(dev)
    reading.setup_s = time.perf_counter() - r.t0

    picks = sample_positions(t, r.seed)
    kept, done, attempted, failed = [], [], 0, 0
    limit = float(t["trace_seconds"]) if r.trace else r.seconds
    before = cell.launch_counts()
    tl_out: dict = {}

    def loop():
        nonlocal attempted, failed
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < limit:
            c_s, b_s, out = one(i, i in picks)
            reading.collate_s.append(c_s)
            reading.batch_s.append(b_s)
            evs, met = out[0], out[1]
            attempted += len(evs)
            failed += int((~np.isfinite(met[:len(evs)]).all(axis=1)).sum())
            done.append(i % len(pool))
            if i in picks:
                kept.append(out)
            i += 1
        return time.perf_counter() - t0

    if r.trace:
        with tracing.traced(tl_out):
            with tracing.span("window"):
                reading.trace_window_s = loop()
        reading.trace_collate_s = list(reading.collate_s)
    else:
        reading.window_s = loop()
    reading.events = attempted
    launches = cell.delta(cell.launch_counts(), before)
    peak = cell.peak_bytes(dev)
    fam.release()
    cell.free(dev)

    out = cell.Outcome(reading, {}, attempted, failed, peak)
    if reading.batch_s:
        out.notes.append(
            f"{len(reading.batch_s)} batches; median batch "
            f"{1e3 * statistics.median(reading.batch_s):.3f} ms, median "
            f"collate {1e3 * statistics.median(reading.collate_s):.3f} ms")
    if r.trace:
        tl = tl_out.get("timeline")
        pats = cell.kernel_patterns()
        reading.covers, seen = tracing.coverage(tl, launches,
                                                pats["per_wrapper"])
        out.notes.append(f"trace coverage (counter, trace): {seen}")
        if tl is not None:
            reading.busy_s = tl.busy_s()
            reading.port_kernel_s = tl.matching(pats["port"])[0]
            reading.bound_s, reading.ops = fam.counts(
                [pool[i] for i in done], [widths[i] for i in done])
            out.breakdown = {
                "device_ops": [list(x) for x in tl.top_ops()],
                "idle_gaps": [list(x) for x in tl.idle_by_host()]}
    if not kept:
        out.notes.append("no sampled batch ran in the window")
        out.failed = max(out.failed, 1)
        return out
    out.checks = cell.judge(fam.check(kept), r.spec.limits)
    return out
