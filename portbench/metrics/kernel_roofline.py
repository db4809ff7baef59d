"""The port's hand-written kernels against their bounds in the traced
window: the sum of each call's bound (counts/: the larger of its bytes
over 3.35 TB/s and its float32 operations over 67 TFLOP/s, from what the
inputs need) over the sum of those kernels' device time in the trace."""


def read(r):
    if not r.port_kernel_s or not r.bound_s:
        return None
    return 100.0 * r.bound_s / r.port_kernel_s
