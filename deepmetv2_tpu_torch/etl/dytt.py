"""DY/ttbar ETL (the JAX package's ``etl/dytt.py``) — reference data_dytt/generate_npz.py:66-146 semantics.

Dileptonic samples: select events with >= n tight leptons, subtract the
leading ``n_subtract`` leptons' momenta from every MET flavor (lepton
recoil correction), remove each lepton's closest PF candidate within
ΔR < 0.001, pad, save.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from deepmetv2_tpu_torch.etl import common


def select_tight_muons(mu: Dict[str, np.ndarray]) -> np.ndarray:
    """tightId && pfRelIso03_all < 0.15 && pt > 20
    (reference data_dytt/generate_npz.py:70-72)."""
    return ((np.asarray(mu["tightId"]) == 1)
            & (np.asarray(mu["pfRelIso03_all"]) < 0.15)
            & (np.asarray(mu["pt"]) > 20.0))


def select_tight_electrons(el: Dict[str, np.ndarray]) -> np.ndarray:
    """mvaFall17V1Iso_WP80 && pt > 20
    (reference data_dytt/generate_npz.py:74-76)."""
    return ((np.asarray(el["mvaFall17V1Iso_WP80"]) == 1)
            & (np.asarray(el["pt"]) > 20.0))


def process_chunk_dytt(
    chunk: Dict,
    n_leptons: int = 2,
    n_leptons_subtract: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Process one chunk → (x [12, nev', nmax], y [nev', 11]).

    ``chunk`` layout: see etl/common.py.  Events failing the tight-lepton
    count are dropped (reference :78-81).
    """
    assert n_leptons >= n_leptons_subtract
    n_events = len(chunk["PFCands"]["pt"])
    kept_pf: List[Dict[str, np.ndarray]] = []
    ys: List[np.ndarray] = []

    for e in range(n_events):
        mu = {k: np.asarray(v[e]) for k, v in chunk["Muon"].items()}
        el = {k: np.asarray(v[e]) for k, v in chunk["Electron"].items()}
        mu_sel = select_tight_muons(mu) if len(mu["pt"]) else np.zeros(0, bool)
        el_sel = (select_tight_electrons(el) if len(el["pt"])
                  else np.zeros(0, bool))
        if int(mu_sel.sum()) + int(el_sel.sum()) < n_leptons:
            continue

        # mix tight leptons, sort by descending pt, keep leading n_subtract
        # (reference :83-91)
        lep_pt = np.concatenate([mu["pt"][mu_sel], el["pt"][el_sel]])
        lep_eta = np.concatenate([mu["eta"][mu_sel], el["eta"][el_sel]])
        lep_phi = np.concatenate([mu["phi"][mu_sel], el["phi"][el_sel]])
        order = np.argsort(-lep_pt, kind="stable")[:n_leptons_subtract]
        lep_pt, lep_eta, lep_phi = lep_pt[order], lep_eta[order], lep_phi[order]
        lep_px = float(np.sum(lep_pt * np.cos(lep_phi)))
        lep_py = float(np.sum(lep_pt * np.sin(lep_phi)))

        # recoil-corrected targets (reference :95-107)
        def xy(coll):
            px, py = common.met_xy(np.asarray(chunk[coll]["pt"][e]),
                                   np.asarray(chunk[coll]["phi"][e]))
            return float(px) + lep_px, float(py) + lep_py

        y = np.empty(11, np.float32)
        y[0], y[1] = xy("GenMET")
        y[2], y[3] = xy("MET")
        y[4], y[5] = xy("PuppiMET")
        y[6], y[7] = xy("DeepMETResponseTune")
        y[8], y[9] = xy("DeepMETResolutionTune")
        y[10] = float(chunk["LHE"]["HT"][e])

        # lepton-PF overlap removal (reference :108-117)
        pf = {k: np.asarray(v[e]) for k, v in chunk["PFCands"].items()}
        keep = common.overlap_removal_mask(pf["eta"], pf["phi"],
                                           lep_eta, lep_phi)
        kept_pf.append({k: v[keep] for k, v in pf.items()})
        ys.append(y)

    if not ys:
        return (np.zeros((12, 0, 0), np.float32), np.zeros((0, 11), np.float32))
    x = common.pad_particle_list(kept_pf)
    return x, np.stack(ys)
