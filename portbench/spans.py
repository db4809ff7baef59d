"""The program's spans in a Chrome trace of the card, and the device time
each one launched.

The port marks its layer boundaries with
``deepmetv2_tpu_torch.utils.profiling.annotate`` (every name in its
``SPANS``), recorded only inside ``profiling.spans_on()``.  In a
``torch.profiler`` trace a span is a host event (``user_annotation``) on
the thread that ran it, on the clock of the device's kernels, copies and
sets.  ``read(path)`` joins each device event to the runtime or driver
call that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
``cudaGraphLaunch``, ...) through ``args.correlation``, and files it
under the spans of the launching thread that hold that call: the
innermost and every one around it, program and benchmark spans alike.  A
device event whose launch the trace lacks is unattributed; where that is
more than ``MAX_UNATTRIBUTED`` of the device time, the per-span device
readings are None, as ``device_idle`` reads nothing where the trace
misses launches.  A span inside a captured CUDA graph runs at capture
only, so a replay's device work falls under the span around the replay
(``chain.replay``).

``readings(spans)`` gives, per traced batch: ``step_dispatch_ms``, the
median host time of ``step.eval`` (the step's dispatch: it ends when the
outputs are enqueued); ``to_device_ms``, the median host time of
``data.to_device`` (the batch's copy, pageable, so the host waits);
``graph_build_ms`` and ``graph_match_ms``, the device time launched under
``graph.knn`` and ``graph.match`` over the traced evaluation steps.
"""

from __future__ import annotations

import json
import statistics
from typing import Dict, List, NamedTuple, Optional, Tuple

from portbench.tracing import DEVICE_CATS, PREFIX

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MAX_UNATTRIBUTED = 0.01


class Spans(NamedTuple):
    host: Dict[str, List[float]]         # span name -> host durations (s)
    # (enclosing spans, outermost first; device event name) -> seconds
    device: Dict[Tuple[Tuple[str, ...], str], float]
    unattributed_s: float                # device time with no launch seen
    spans: List[Tuple[str, float, float]]  # (name, start, end), s

    def device_s(self, name: str) -> float:
        """Device seconds launched inside ``name``, at any depth."""
        return sum(s for (stack, _), s in self.device.items()
                   if name in stack)

    def total_s(self) -> float:
        return sum(self.device.values()) + self.unattributed_s

    def unattributed_share(self) -> float:
        total = self.total_s()
        return self.unattributed_s / total if total else 0.0

    def batches(self) -> int:
        """Traced evaluation steps."""
        return len(self.host.get("step.eval", []))

    def host_ms(self, name: str) -> Optional[float]:
        """Median host time of ``name``, in ms."""
        d = self.host.get(name)
        return 1e3 * statistics.median(d) if d else None

    def device_ms(self, name: str) -> Optional[float]:
        """Device ms launched under ``name`` per traced batch; None where
        the trace misses launches or holds no batch."""
        if not self.batches() or (self.unattributed_share()
                                  > MAX_UNATTRIBUTED):
            return None
        return 1e3 * self.device_s(name) / self.batches()

    def idle_by_span(self, gaps: List[Tuple[float, float]], top: int = 10
                     ) -> List[Tuple[str, float]]:
        """Idle seconds by the innermost span of either kind at each gap's
        middle ('host: other' where none holds it), the largest first."""
        order = sorted((s for s in self.spans if s[0] != "window"),
                       key=lambda s: s[1])
        acc: Dict[str, float] = {}
        active: List[Tuple[str, float, float]] = []
        j = 0
        for a, b in sorted(gaps):
            mid = 0.5 * (a + b)
            while j < len(order) and order[j][1] <= mid:
                active.append(order[j])
                j += 1
            active = [s for s in active if s[2] >= mid]
            name = (min(active, key=lambda s: s[2] - s[1])[0] if active
                    else "host: other")
            acc[name] = acc.get(name, 0.0) + (b - a)
        return sorted(acc.items(), key=lambda kv: -kv[1])[:top]


def _stacks(spans, launches) -> Dict[int, Tuple[str, ...]]:
    """Correlation id -> the names of the spans that hold its launch,
    outermost first: one sweep per thread, spans nesting in time."""
    out: Dict[int, Tuple[str, ...]] = {}
    for thread, calls in launches.items():
        own = sorted(spans.get(thread, []), key=lambda s: (s[1], -s[2]))
        stack: List[Tuple[str, float, float]] = []
        j = 0
        for ts, corr in sorted(calls):
            while j < len(own) and own[j][1] <= ts:
                _, s, e = own[j]
                while stack and not stack[-1][1] <= s <= e <= stack[-1][2]:
                    stack.pop()
                stack.append(own[j])
                j += 1
            while stack and stack[-1][2] < ts:
                stack.pop()
            out[corr] = tuple(n for n, _, _ in stack)
    return out


def read(path: str) -> Spans:
    """The spans and attributed device time of a Chrome trace, inside its
    benchmark ``window`` span where it has one."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    xs = [ev for ev in events if ev.get("ph") == "X" and "dur" in ev]
    window = (float("-inf"), float("inf"))
    for ev in xs:
        if (ev.get("cat") == "user_annotation"
                and ev.get("name") == PREFIX + "window"):
            s = float(ev["ts"]) * 1e-6
            window = (s, s + float(ev["dur"]) * 1e-6)

    def inside(t: float) -> bool:
        return window[0] <= t <= window[1]

    spans: Dict[tuple, list] = {}
    launches: Dict[tuple, list] = {}
    devices = []
    for ev in xs:
        cat = ev.get("cat", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        thread = (ev.get("pid"), ev.get("tid"))
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation":
            name = ev.get("name", "")
            if name.startswith(PREFIX):
                name = name[len(PREFIX):]
            spans.setdefault(thread, []).append((name, s, e))
        elif cat in LAUNCH_CATS and corr is not None:
            launches.setdefault(thread, []).append((s, corr))
        elif cat in DEVICE_CATS and inside(s):
            devices.append((ev.get("name", ""), e - s, corr))
    stacks = _stacks(spans, launches)
    device: Dict[Tuple[Tuple[str, ...], str], float] = {}
    lost = 0.0
    for name, dur, corr in devices:
        if corr not in stacks:
            lost += dur
            continue
        key = (stacks[corr], name)
        device[key] = device.get(key, 0.0) + dur
    host: Dict[str, List[float]] = {}
    flat = []
    for thread_spans in spans.values():
        for name, s, e in thread_spans:
            if inside(s):
                host.setdefault(name, []).append(e - s)
                flat.append((name, s, e))
    return Spans(host, device, lost, flat)


def readings(sp: Spans) -> Dict[str, Optional[float]]:
    """The per-layer readings of a traced run, per traced batch (ms)."""
    return {"step_dispatch_ms": sp.host_ms("step.eval"),
            "to_device_ms": sp.host_ms("data.to_device"),
            "graph_build_ms": sp.device_ms("graph.knn"),
            "graph_match_ms": sp.device_ms("graph.match")}
