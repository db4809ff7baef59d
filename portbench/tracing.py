"""The benchmark's own spans, and the reading of a ``torch.profiler``
trace of the card.

``span(name)`` marks a call into one of the port's layers (the driver's
epoch, a step, collate, to_device, the fetch of outputs) with
``torch.profiler.record_function``;
outside a traced run it costs a context manager.  ``traced()`` profiles
the CPU and the card, writes the Chrome trace to a temporary file and
reads it back into a ``Timeline``: the device's busy intervals (kernels,
copies and sets; their union, never summed per kernel), each kernel's
time and count by name, and the host spans.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


class Timeline(NamedTuple):
    busy: List[Tuple[float, float]]      # merged device intervals (s)
    kernels: Dict[str, float]            # kernel name -> seconds
    counts: Dict[str, int]               # kernel name -> launches
    spans: List[Tuple[str, float, float]]  # host spans (name, start, end)
    window: Tuple[float, float]          # the "window" span (s)

    def busy_s(self) -> float:
        lo, hi = self.window
        return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in self.busy)

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the device inside the window."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy:
            if e <= lo or s >= hi:
                continue
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def idle_by_host(self, top: int = 10) -> List[Tuple[str, float]]:
        """Idle seconds by the innermost host span at each gap's middle
        ('host: other' where none holds it), the largest first."""
        acc: Dict[str, float] = {}
        inner = sorted((s for s in self.spans if s[0] != "window"),
                       key=lambda s: s[2] - s[1])
        for a, b in self.gaps():
            mid = 0.5 * (a + b)
            name = next((n for n, s, e in inner if s <= mid <= e),
                        "host: other")
            acc[name] = acc.get(name, 0.0) + (b - a)
        return sorted(acc.items(), key=lambda kv: -kv[1])[:top]

    def top_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]

    def matching(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches."""
        rx = re.compile(pattern)
        names = [k for k in self.kernels if rx.search(k)]
        return (sum(self.kernels[k] for k in names),
                sum(self.counts[k] for k in names))


def read_trace(path: str) -> Timeline:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    busy, kernels, counts, spans = [], {}, {}, []
    window = None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            busy.append((s, e))
            if cat == "kernel":
                kernels[name] = kernels.get(name, 0.0) + (e - s)
                counts[name] = counts.get(name, 0) + 1
        elif cat == "user_annotation" and name.startswith(PREFIX):
            short = name[len(PREFIX):]
            if short == "window":
                window = (s, e)
            else:
                spans.append((short, s, e))
    busy.sort()
    merged: List[Tuple[float, float]] = []
    for s, e in busy:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    if window is None:
        raise RuntimeError("the trace holds no 'window' span")
    return Timeline(merged, kernels, counts, spans, window)


@contextlib.contextmanager
def traced(out: dict):
    """Profile the body (CPU and card); ``out['timeline']`` holds the
    ``Timeline`` once it has ended.  The body marks its measured part with
    ``span('window')``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["timeline"] = read_trace(path)
    finally:
        os.remove(path)


def coverage(tl: Optional[Timeline], launches: Dict[str, int],
             kernels: Dict[str, str]) -> Tuple[bool, Dict[str, list]]:
    """Whether the trace holds every launch the port's counters saw in the
    traced window: for each counted wrapper with a kernel pattern, the
    trace's launches of that kernel against the counter's."""
    seen = {}
    ok = tl is not None and any(launches.values())
    for wrapper, n in launches.items():
        if n == 0 or wrapper not in kernels:
            continue
        got = tl.matching(kernels[wrapper])[1] if tl else 0
        seen[wrapper] = [n, got]
        ok = ok and got == n
    return ok, seen
