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

The model comes from the configuration's family
(``families/<family>.py``), whose class ``Serve(run, events)`` has
``step(batch, keep)`` (the evaluation step on a device batch: the MET and
per-candidate outputs on the host, and what the check needs of a kept
batch), ``release()`` (drop the model), ``check(kept)`` (the compared
numbers over the kept batches, by the names of the cell's limits) and
``counts(batches, widths)`` (the batches' kernel bound in seconds and the
model's operations).
"""

from __future__ import annotations

import statistics
import time

import numpy as np

from portbench import cell, spec, tracing
from portbench.gen import events as gen

ROLE = "Serve"      # the class of the family this entry drives



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
    fam = spec.family(cfgj["family"], ROLE)(r, events)
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
    with cell.deterministic():
        values = fam.check(kept)
    out.checks = cell.judge(values, r.spec.limits)
    return out
