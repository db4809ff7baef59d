"""deepmetv2_tpu_torch — the PyTorch/CUDA port of deepmetv2_tpu.

GraphMETNetwork serving (evaluate, predict) in window mode, with the
windowed EdgeConv aggregation as a hand-written Hopper kernel
(``csrc/window_max.cu``).  The JAX package ``deepmetv2_tpu`` is the
reference and is never imported from here.
"""

__version__ = "0.1.0"
