"""Plots of a run's artifacts (the JAX package's ``plotting/``): the
resolution curves of a ``.resolutions`` file and the learned-weight
diagnostics, both with matplotlib's Agg backend."""

from deepmetv2_tpu_torch.plotting.resolution import (  # noqa: F401
    plot_resolutions)
from deepmetv2_tpu_torch.plotting.weights import (  # noqa: F401
    compute_weight_summary, plot_weight_summary)
