"""Profiling and tracing on ``torch.profiler``:

* ``trace(logdir)``: a context manager that records the enclosed region,
  host and, where there is one, CUDA device activity, and writes it as a
  Chrome/Perfetto trace (``trace.json``) into ``logdir``;
* ``annotate(name)``: the port's one span, a named region of the trace
  at a layer boundary.  Spans are on only inside ``spans_on()``, which
  ``trace`` enters: there ``annotate`` is
  ``torch.profiler.record_function(name)``, a host event in the same
  trace as the kernels, copies and sets it launches, on the same clock.
  Everywhere else it returns one shared null context after one flag
  check, and calls nothing into the profiler;
* ``SPANS``: every name the port passes to ``annotate``, with what reads
  it (a test keeps the two in step).

A span inside a captured CUDA graph runs at capture only: a replay's
device work shows under the span around the replay (``chain.replay``).
"""

from __future__ import annotations

import contextlib
import os

import torch

SPANS = {
    "data.collate": "host data: the host's padding of events into a batch "
                    "(data/batching.py:collate)",
    "data.to_device": "host data: the batch's host-to-device copy "
                      "(data/batching.py:to_device); its host duration is "
                      "the pageable copy's wait",
    "step.eval": "step: an evaluation step of either family, entry until "
                 "its outputs are enqueued; its host duration is the "
                 "step's dispatch, its children split its device time",
    "step.train": "step: one eager train step (forward, backward, clip, "
                  "AdamW); inside a captured chain it runs at capture only",
    "graph.sort": "graph ops: the eta sort of window mode (sort_by_eta)",
    "graph.unsort": "graph ops: the weights' inverse-permutation gather "
                    "back to the caller's order",
    "graph.knn": "graph ops: the DRN round's kNN graph build (the knn_kth "
                 "and knn_extract kernels, or the composed build); each of "
                 "ParticleNet's three directed builds",
    "graph.match": "graph ops: the DRN round's normalized-cut weights and "
                   "handshake matching",
    "graph.pool": "graph ops: the DRN round's max pooling and compaction",
    "model.embed": "model: GraphMET's embeddings and encoder through "
                   "bn_all; the DRN's input network; ParticleNet's input "
                   "BatchNorm",
    "model.conv": "model: one EdgeConv block (GraphMET's window EdgeConv "
                  "and BatchNorm, the DRN round's edge-MLP conv, "
                  "ParticleNet's edge block and shortcut)",
    "model.head": "model: the output network (the DRN's after its "
                  "per-event max pool; ParticleNet's fusion, mean pool "
                  "and FC layers)",
    "chain.warm_up": "feed: a chain's first, eager run on the capture "
                     "stream",
    "chain.capture": "feed: the capture of a chain into a CUDA graph",
    "chain.replay": "feed: a chain's static-input copies, its graph "
                    "replay and the losses' clone; the replay's device "
                    "work falls under it",
    "feed.stage": "feed: the resident epoch's staging on the device",
    "train.epoch_end": "driver: the epoch's final loss stack and its "
                       "float(), where the host waits for the epoch",
}

_NULL = contextlib.nullcontext()
_on = False


def annotate(name: str):
    """A named region of the trace (``name`` in ``SPANS``), recorded only
    inside ``spans_on()``; elsewhere the shared null context."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spans_on():
    """Turn the port's spans on for the enclosed region (for a profiler
    that the caller runs around it)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed region (CPU, and CUDA when it is available),
    the port's spans on, and write ``<logdir>/trace.json``; yields the
    profiler, whose ``key_averages()`` sums the region by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with spans_on(), torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
