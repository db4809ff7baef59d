"""Evaluation driver (the JAX package's ``train/loop.py:evaluate``;
reference evaluate.py:31-164).  The training loop comes with the training
slice."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.config import Config
from deepmetv2_tpu_torch.data.loader import PaddedLoader, device_feed
from deepmetv2_tpu_torch.train import metrics as metrics_mod


def evaluate(model, eval_step, loader: PaddedLoader, cfg: Config, device,
             verbose: bool = True) -> Tuple[Dict[str, float], Dict]:
    """Full validation pass + qT-binned resolution summary.  Losses and
    per-event metrics stay on the device until the end of the pass."""
    losses = []
    arrs, qts, evs = [], [], []
    has_deepmet = False
    for batch in device_feed(loader, device):
        w, loss = eval_step(model, batch)
        losses.append(loss)
        has_deepmet = bool(batch.y.shape[1] > 6)
        v_met = metrics_mod._neg_weighted_met(w, batch)
        arr, qt = metrics_mod._decompose_all(v_met, batch.y, has_deepmet)
        arrs.append(arr)
        qts.append(qt)
        evs.append(batch.num_valid)
    if arrs:
        resolutions_arr, qt_arr = metrics_mod.finalize_resolutions(
            arrs, qts, evs, has_deepmet)
    else:
        resolutions_arr, qt_arr = {}, np.zeros((0,))

    hists = metrics_mod.resolution_histograms(
        resolutions_arr, qt_arr,
        max_qt=cfg.train.qt_max,
        bin_width=cfg.train.qt_bin_width,
        hist_bins=cfg.train.qt_hist_bins,
    )
    metrics_mean = {"loss": float(torch.stack(losses).mean())
                    if losses else float("inf")}
    if verbose:
        print("- Eval metrics : " +
              " ; ".join(f"{k}: {v:05.3f}" for k, v in metrics_mean.items()))
    return metrics_mean, hists
