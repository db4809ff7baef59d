"""Profiling and tracing (the JAX package's ``utils/profiling.py``) on
``torch.profiler``:

* ``trace(logdir)``: a context manager that records the enclosed region,
  host and, where there is one, CUDA device activity, and writes it as a
  Chrome/Perfetto trace (``trace.json``) into ``logdir``;
* ``annotate(name)``: a named region of the trace
  (``torch.profiler.record_function``; on a CUDA device the profiler's
  NVTX range joins it);
* ``StepProfiler``: host-side wall-clock times per step and edge counts,
  summarized as step-time percentiles and edges per second per device,
  with the JAX module's keys and arithmetic.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed region (CPU, and CUDA when it is available) and
    write ``<logdir>/trace.json``; yields the profiler, whose
    ``key_averages()`` sums the region by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region of the trace."""
    return torch.profiler.record_function(name)


class StepProfiler:
    """Accumulates per-step timings and work counters; reports edges/s per
    device and step-time percentiles.  A step's time is the host clock from
    ``step_start`` to ``step_end``: the caller synchronizes the device
    before ``step_end`` where the step's device time must be inside."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = max(1, n_chips)
        self._times: List[float] = []
        self._edges: List[int] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        return False

    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self, num_edges: int = 0) -> float:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self._times.append(dt)
        self._edges.append(int(num_edges))
        return dt

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        ts = np.asarray(self._times[skip_warmup:] or self._times)
        es = np.asarray(self._edges[skip_warmup:] or self._edges)
        total_t = float(ts.sum()) if len(ts) else 0.0
        return {
            "steps": int(len(ts)),
            "mean_step_ms": float(ts.mean() * 1e3) if len(ts) else 0.0,
            "p50_step_ms": (float(np.percentile(ts, 50) * 1e3) if len(ts)
                            else 0.0),
            "p99_step_ms": (float(np.percentile(ts, 99) * 1e3) if len(ts)
                            else 0.0),
            "edges_per_s_per_chip": (
                float(es.sum()) / total_t / self.n_chips if total_t else 0.0),
            "steps_per_s": float(len(ts)) / total_t if total_t else 0.0,
        }
