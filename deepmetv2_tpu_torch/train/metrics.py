"""Hadronic-recoil resolution and response (the JAX package's
``train/metrics.py``; reference model/net.py:92-157, evaluate.py:110-156).
The per-event vector algebra runs on the device; the qT-binned quantile
summary runs in numpy on the host, as the reference does."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.data.batching import EventBatch
from deepmetv2_tpu_torch.train.loss import weighted_met

# baseline MET flavours: column pairs in y (reference model/net.py:101-124)
_BASELINES = {
    "pfMET": (2, 3),
    "puppiMET": (4, 5),
    "deepMETResponse": (6, 7),
    "deepMETResolution": (8, 9),
}


def _decompose(vec: torch.Tensor, v_qt: torch.Tensor):
    """u_perp, u_par, response of a MET estimate against the truth qT
    (reference model/net.py:138-144)."""
    dot = (vec * v_qt).sum(1)
    qt2 = (v_qt * v_qt).sum(1)
    response = dot / qt2
    v_par = response[:, None] * v_qt
    u_par = torch.sqrt((v_par * v_par).sum(1)) - torch.sqrt(qt2)
    v_perp = vec - v_par
    u_perp = torch.sqrt((v_perp * v_perp).sum(1))
    return u_perp, u_par, response


def _neg_weighted_met(weights: torch.Tensor, batch: EventBatch) -> torch.Tensor:
    """The MET estimate ``−Σ w p`` as ``[B, 2]``."""
    metx, mety = weighted_met(weights, batch)
    return -torch.stack([metx, mety], dim=1)


def _baseline_keys(has_deepmet: bool):
    return [n for n in _BASELINES
            if has_deepmet or not n.startswith("deepMET")]


def _decompose_all(v_met: torch.Tensor, y: torch.Tensor, has_deepmet: bool):
    """``[1 + n_baselines, 3, B]`` stack of (u_perp, u_par, response), and qT."""
    v_qt = y[:, 0:2]
    rows = [torch.stack(_decompose(v_met, v_qt), dim=0)]
    for name in _baseline_keys(has_deepmet):
        cx, cy = _BASELINES[name]
        vb = torch.stack([y[:, cx], y[:, cy]], dim=1)
        rows.append(torch.stack(_decompose(vb, v_qt), dim=0))
    qt = torch.sqrt(y[:, 0] ** 2 + y[:, 1] ** 2)
    return torch.stack(rows, dim=0), qt


def finalize_resolutions(arrs, qts, num_valids, has_deepmet: bool
                         ) -> Tuple[Dict[str, List[np.ndarray]], np.ndarray]:
    """Concatenate the per-batch device stacks of ``_decompose_all``, fetch
    them to the host once, and drop batch-padding events."""
    arr = torch.cat(arrs, dim=2).cpu().numpy()       # [K, 3, ΣB]
    qt = torch.cat(qts).cpu().numpy()
    ev = torch.cat([torch.as_tensor(v) for v in num_valids]).cpu().numpy() > 0
    keys = ["MET"] + _baseline_keys(has_deepmet)
    out: Dict[str, List[np.ndarray]] = {
        key: [arr[k, 0][ev], arr[k, 1][ev], arr[k, 2][ev]]
        for k, key in enumerate(keys)
    }
    return out, qt[ev]


def resolution_histograms(
    resolutions_arr: Dict[str, List[np.ndarray]],
    qt_arr: np.ndarray,
    max_qt: float = 400.0,
    bin_width: float = 10.0,
    hist_bins: int = 40,
) -> Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """qT-binned quantile resolutions (reference evaluate.py:110-156): per
    10-GeV qT bin, (q84 − q16)/2 of u_perp and u_par (raw and scaled by the
    mean response) and the mean response, as ``np.histogram`` (weights,
    edges) tuples — the on-disk contract of ``.resolutions``."""
    bin_edges = np.arange(0, max_qt, bin_width)
    inds = np.digitize(qt_arr, bin_edges)
    qt_centers = [(bin_edges[i] + bin_edges[i - 1]) / 2.0
                  for i in range(1, len(bin_edges))]

    def q68(a):
        if len(a) == 0:
            return np.nan
        return (np.quantile(a, 0.84) - np.quantile(a, 0.16)) / 2.0

    hists: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {}
    for key, (u_perp_arr, u_par_arr, r_arr) in resolutions_arr.items():
        u_perp_hist, u_perp_scaled_hist = [], []
        u_par_hist, u_par_scaled_hist, r_hist = [], [], []
        for i in range(1, len(bin_edges)):
            sel = np.where(inds == i)[0]
            r_mean = np.mean(r_arr[sel]) if len(sel) else np.nan
            r_hist.append(r_mean)
            u_perp_i = u_perp_arr[sel]
            u_par_i = u_par_arr[sel]
            u_perp_hist.append(q68(u_perp_i))
            u_perp_scaled_hist.append(q68(u_perp_i / r_mean) if len(sel) else np.nan)
            u_par_hist.append(q68(u_par_i))
            u_par_scaled_hist.append(q68(u_par_i / r_mean) if len(sel) else np.nan)

        def hist(weights):
            return np.histogram(qt_centers, bins=hist_bins, range=(0, max_qt),
                                weights=weights)

        hists[key] = {
            "u_perp_resolution": hist(u_perp_hist),
            "u_perp_scaled_resolution": hist(u_perp_scaled_hist),
            "u_par_resolution": hist(u_par_hist),
            "u_par_scaled_resolution": hist(u_par_scaled_hist),
            "R": hist(r_hist),
        }
    return hists
