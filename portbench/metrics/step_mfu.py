"""The model's operations for the traced window's batches
(counts/model.py, the cheapest formulation) over the window's wall time
at the card's float32 peak of 67 TFLOP/s."""

from portbench.counts.peaks import FP32_OPS_PER_S


def read(r):
    if not r.trace_window_s or not r.ops:
        return None
    return 100.0 * r.ops / (r.trace_window_s * FP32_OPS_PER_S)
