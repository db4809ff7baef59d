"""Resolution and response curves (the JAX package's
``plotting/resolution.py``; reference plt.py).

Draws the five MET-performance figures (sigma(u_perp), scaled
sigma(u_perp), sigma(u_par), scaled sigma(u_par), response vs qT) for
{GraphMET, PF, PUPPI, DeepMETResponse, DeepMETResolution} from a
``.resolutions`` artifact of either package or of the reference (one
on-disk format), under the same file names.  CMS style through mplhep
where it is installed; plain matplotlib otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional

COLORS = {
    "pfMET": "black",
    "puppiMET": "red",
    "deepMETResponse": "blue",
    "deepMETResolution": "green",
    "MET": "magenta",
}
LABELS = {
    "MET": "Graph MET",
    "pfMET": "PF MET",
    "puppiMET": "PUPPI MET",
    "deepMETResponse": "DeepMETResponse",
    "deepMETResolution": "DeepMETResolution",
}

# (artifact key, filename suffix, y label, y max) — reference plt.py:39-107
_FIGURES = [
    ("u_perp_resolution", "resol_perp.png",
     r"$\sigma (u_{\perp})$ [GeV]", 35),
    ("u_perp_scaled_resolution", "resol_perp_scaled.png",
     r"Scaled $\sigma (u_{\perp})$ [GeV]", 35),
    ("u_par_resolution", "resol_parallel.png",
     r"$\sigma (u_{\parallel})$ [GeV]", 60),
    ("u_par_scaled_resolution", "resol_parallel_scaled.png",
     r"Scaled $\sigma (u_{\parallel})$ [GeV]", 60),
    ("R", "response_parallel.png",
     r"Response $-\frac{<u_{\parallel}>}{<q_{T}>}$", 1.2),
]


def plot_resolutions(resolutions: Dict, out_prefix: str,
                     y_limits: Optional[Dict[str, float]] = None) -> list:
    """Write the five comparison PNGs ``<out_prefix><name>.png``; returns
    the file paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        import mplhep as hep
        plt.style.use(hep.style.CMS)
    except ImportError:
        pass

    written = []
    for key, suffix, ylabel, ymax in _FIGURES:
        fig, ax = plt.subplots(figsize=(8, 6))
        for flavor, hists in resolutions.items():
            if key not in hists:
                continue
            weights, edges = hists[key]
            n = len(weights)
            xx = edges[:n]
            ax.plot(xx, weights, color=COLORS.get(flavor, None),
                    label=LABELS.get(flavor, flavor))
        if key == "R":
            ax.axhline(y=1.0, color="black", linestyle="-.")
        if y_limits and key in y_limits:
            ymax = y_limits[key]
        ax.axis([0, 400, 0, ymax])
        ax.set_xlabel(r"$q_{T}$ [GeV]")
        ax.set_ylabel(ylabel)
        ax.legend()
        path = out_prefix + suffix
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written
