"""Learned-weight diagnostics (the JAX package's ``plotting/weights.py``;
reference plt_weight.py).

Runs GraphMET's evaluation step over a loader and accumulates, per
particle class (HF / e / mu / gamma / neutral hadron / charged hadron):

* the mean learned weight vs pT, vs |eta| and vs puppiWeight;
* the weight distribution of charged hadrons split by puppi in {0, 1};
* the qT spectra of all six MET flavours.

The summary's keys, labels and bin edges are the reference's ``weight.plt``
layout (reference plt_weight.py:50-206) and the JAX package's, in
vectorized numpy over padded batches.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from deepmetv2_tpu_torch.data.batching import to_device
from deepmetv2_tpu_torch.train.loss import weighted_met

CLASS_LABELS = {
    1: "HF Candidate",
    11: "Electron",
    13: "Muon",
    22: "Gamma",
    130: "Neutral Hadron",
    211: "Charged Hadron",
}

BIN_EDGES = {
    "Pt": np.arange(-0.05, 25.05, 0.1),
    "eta": np.arange(-0.1, 5.1, 0.2),
    "Puppi": [-0.05, 0.05, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5, 0.55, 0.6,
              0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 1.1],
    "graph_weight": np.arange(-0.05, 1.15, 0.01),
    "qT1D": np.arange(0, 420, 20),
}


def compute_weight_summary(eval_step, model, loader, device="cpu") -> Dict:
    """The diagnostic summary over ``loader``'s host batches, each run on
    ``device`` through ``eval_step(model, batch) -> (v_met, loss,
    weights)`` (train/step.py:make_eval_step); the weights and the per-event
    MET sums come back to the host, the histograms are numpy."""
    e = BIN_EDGES
    acc_pt_w = {lab: 0.0 for lab in CLASS_LABELS.values()}
    acc_pt_n = {lab: 0.0 for lab in CLASS_LABELS.values()}
    acc_eta_w = {lab: 0.0 for lab in CLASS_LABELS.values()}
    acc_eta_n = {lab: 0.0 for lab in CLASS_LABELS.values()}
    puppi_classes = (1, 22, 130)
    acc_pu_w = {CLASS_LABELS[k]: 0.0 for k in puppi_classes}
    acc_pu_n = {CLASS_LABELS[k]: 0.0 for k in puppi_classes}
    ch_hist = {"puppi0": 0.0, "puppi1": 0.0}
    qt_hist = {k: 0.0 for k in ["TrueMET", "GraphMET", "PFMET", "PUPPIMET",
                                "DeepMETResponse", "DeepMETResolution"]}

    def hist_pt(vals, w):
        return np.histogram(vals, bins=e["Pt"], weights=w)[0]

    for batch in loader:
        placed = to_device(batch, device)
        _, _, w = eval_step(model, placed)
        metx, mety = (t.cpu().numpy() for t in weighted_met(w, placed))
        w = w.cpu().numpy()
        mask = np.asarray(batch.mask)
        x_cont = np.asarray(batch.x_cont)
        x_cat = np.asarray(batch.x_cat)
        y = np.asarray(batch.y)
        ev = np.asarray(batch.num_valid) > 0

        # qT spectra (reference plt_weight.py:126-146)
        gqt = np.sqrt(metx ** 2 + mety ** 2)[ev]
        qts = {
            "TrueMET": np.sqrt(y[:, 0] ** 2 + y[:, 1] ** 2)[ev],
            "GraphMET": gqt,
            "PFMET": np.sqrt(y[:, 2] ** 2 + y[:, 3] ** 2)[ev],
            "PUPPIMET": np.sqrt(y[:, 4] ** 2 + y[:, 5] ** 2)[ev],
            "DeepMETResponse": np.sqrt(y[:, 6] ** 2 + y[:, 7] ** 2)[ev],
            "DeepMETResolution": np.sqrt(y[:, 8] ** 2 + y[:, 9] ** 2)[ev],
        }
        for k, vals in qts.items():
            qt_hist[k] = qt_hist[k] + np.histogram(vals, bins=e["qT1D"])[0]

        # flatten valid candidates
        sel = mask.reshape(-1)
        pdg = np.abs(x_cat[..., 0].reshape(-1)[sel])
        pt = np.abs(x_cont[..., 2].reshape(-1)[sel])
        eta = np.abs(x_cont[..., 3].reshape(-1)[sel])
        puppi = np.abs(x_cont[..., 7].reshape(-1)[sel])
        wv = w.reshape(-1)[sel]

        for key, lab in CLASS_LABELS.items():
            cls = (pdg == key) | (pdg == 2) if key == 1 else pdg == key
            acc_pt_w[lab] = acc_pt_w[lab] + hist_pt(pt[cls], wv[cls])
            acc_pt_n[lab] = acc_pt_n[lab] + np.histogram(
                pt[cls], bins=e["Pt"])[0]
            acc_eta_w[lab] = acc_eta_w[lab] + np.histogram(
                eta[cls], bins=e["eta"], weights=wv[cls])[0]
            acc_eta_n[lab] = acc_eta_n[lab] + np.histogram(
                eta[cls], bins=e["eta"])[0]

        for key in puppi_classes:
            lab = CLASS_LABELS[key]
            cls = (pdg == key) | (pdg == 2) if key == 1 else pdg == key
            acc_pu_w[lab] = acc_pu_w[lab] + np.histogram(
                puppi[cls], bins=e["Puppi"], weights=wv[cls])[0]
            acc_pu_n[lab] = acc_pu_n[lab] + np.histogram(
                puppi[cls], bins=e["Puppi"])[0]

        # charged-hadron weight distribution split by puppi in {0, 1}
        ch = pdg == 211
        for tag, pval in (("puppi0", 0.0), ("puppi1", 1.0)):
            s = ch & (puppi == pval)
            ch_hist[tag] = ch_hist[tag] + np.histogram(
                wv[s], bins=e["graph_weight"])[0]

    with np.errstate(invalid="ignore", divide="ignore"):
        weight_pt = {lab: np.nan_to_num(acc_pt_w[lab] / acc_pt_n[lab])
                     for lab in acc_pt_w}
        weight_eta = {lab: np.nan_to_num(acc_eta_w[lab] / acc_eta_n[lab])
                      for lab in acc_eta_w}
        weight_puppi = {lab: np.nan_to_num(acc_pu_w[lab] / acc_pu_n[lab])
                        for lab in acc_pu_w}

    return {
        "bin_edges": BIN_EDGES,
        "weight_pt_hist": weight_pt,
        "weight_eta_hist": weight_eta,
        "weight_puppi_hist": weight_puppi,
        "weight_CH_hist": ch_hist,
        "weight_qT_hist": qt_hist,
    }


def plot_weight_summary(summary: Dict, out_prefix: str) -> list:
    """Render the diagnostic histograms to five PNGs
    ``<out_prefix><name>.png``; returns the file paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    e = summary["bin_edges"]
    written = []

    def centers(edges):
        edges = np.asarray(edges, dtype=float)
        return (edges[1:] + edges[:-1]) / 2

    panels = [
        ("weight_pt_hist", "Pt", r"$p_T$ [GeV]", "mean weight",
         "weight_vs_pt.png"),
        ("weight_eta_hist", "eta", r"$|\eta|$", "mean weight",
         "weight_vs_eta.png"),
        ("weight_puppi_hist", "Puppi", "puppi weight", "mean weight",
         "weight_vs_puppi.png"),
    ]
    for key, bins, xlabel, ylabel, fname in panels:
        fig, ax = plt.subplots(figsize=(8, 6))
        for lab, vals in summary[key].items():
            ax.plot(centers(e[bins]), vals, label=lab)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_ylim(0, 1.1)
        ax.legend(fontsize=8)
        path = out_prefix + fname
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    fig, ax = plt.subplots(figsize=(8, 6))
    for tag, vals in summary["weight_CH_hist"].items():
        ax.step(centers(e["graph_weight"]), vals, where="mid", label=tag)
    ax.set_xlabel("learned weight (charged hadrons)")
    ax.set_ylabel("candidates")
    ax.legend()
    path = out_prefix + "weight_ch_dist.png"
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    written.append(path)

    fig, ax = plt.subplots(figsize=(8, 6))
    for tag, vals in summary["weight_qT_hist"].items():
        ax.step(centers(e["qT1D"]), vals, where="mid", label=tag)
    ax.set_xlabel(r"$q_T$ [GeV]")
    ax.set_ylabel("events")
    ax.legend(fontsize=8)
    path = out_prefix + "qt_spectra.png"
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    written.append(path)
    return written
