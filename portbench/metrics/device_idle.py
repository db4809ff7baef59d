"""The card's idle share of the traced window: one minus the union of its
kernel, copy and set intervals in the profiler's timeline over the
window's wall time.  Left out where the trace misses launches the port's
counters saw (CUDA-graph replays the profiler does not record)."""


def read(r):
    if not r.trace_window_s or not r.covers:
        return None
    return 100.0 * (1.0 - r.busy_s / r.trace_window_s)
