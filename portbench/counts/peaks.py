"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12       # HBM3
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
HBM_BYTES = 80e9


def bound_s(nbytes: float, ops: float) -> float:
    """The least time a kernel could take: the larger of its bytes over
    the memory bandwidth and its float32 operations over the float32
    peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
