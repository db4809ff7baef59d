"""ETL common pieces (the JAX package's ``etl/common.py``) — numpy-native
rebuild of the coffea/awkward machinery used by the reference's npz
generators (data_dytt/generate_npz.py:26-63, data_znunu/generate_npz.py).

Data model: a *chunk* is a dict of collections; ragged per-event collections
(Muon, Electron, PFCands) are dicts ``field -> list of 1-D numpy arrays``
(one per event); scalar per-event collections (GenMET, MET, ...) are dicts
``field -> [n_events] array``.  This is exactly the information content of
the NanoAOD branches the reference reads, without the awkward dependency;
adapters.py maps real NanoAOD through coffea when it is installed.

Note the ETL's delta_r DOES wrap phi at ±pi (generate_npz.py:26-30) — only
the *training-time* radius graph has the wraparound bug; semantics of both
are reproduced faithfully in their respective layers.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

PAD = -999.0

PF_FIELDS = ["pt", "eta", "phi", "d0", "dz", "mass", "puppiWeight",
             "pdgId", "charge", "fromPV", "pvRef", "pvAssocQuality"]


def delta_phi(phi1: np.ndarray, phi2: np.ndarray) -> np.ndarray:
    """(phi1 − phi2) wrapped to (−pi, pi] (reference generate_npz.py:26-27)."""
    return (phi1 - phi2 + np.pi) % (2 * np.pi) - np.pi


def delta_r(eta1, phi1, eta2, phi2) -> np.ndarray:
    return np.sqrt((eta1 - eta2) ** 2 + delta_phi(phi1, phi2) ** 2)


def overlap_removal_mask(
    pf_eta: np.ndarray, pf_phi: np.ndarray,
    lep_eta: np.ndarray, lep_phi: np.ndarray,
    radius: float = 0.001,
) -> np.ndarray:
    """Per-candidate keep-mask removing, for each lepton, its single closest
    PF candidate within ``radius``.

    Reproduces ``run_deltar_matching(..., radius=0.001, unique=True)`` +
    zero-match filter (reference data_dytt/generate_npz.py:108-117): a PF
    candidate is dropped iff some lepton lies within the radius AND that
    candidate is the argmin-ΔR PF candidate for that lepton.
    """
    keep = np.ones(len(pf_eta), dtype=bool)
    if len(lep_eta) == 0 or len(pf_eta) == 0:
        return keep
    # [n_pf, n_lep] distances
    dr = delta_r(pf_eta[:, None], pf_phi[:, None],
                 lep_eta[None, :], lep_phi[None, :])
    closest_pf = np.argmin(dr, axis=0)          # per lepton
    for l, p in enumerate(closest_pf):
        if dr[p, l] < radius:
            keep[p] = False
    return keep


def met_xy(pt: np.ndarray, phi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return pt * np.cos(phi), pt * np.sin(phi)


def pad_particle_list(
    pf_per_event: List[Dict[str, np.ndarray]],
    n_max: int | None = None,
) -> np.ndarray:
    """Pad ragged PF candidates into the npz slice layout
    ``[12, n_events, n_max]`` with −999 fill
    (reference data_dytt/generate_npz.py:120-138)."""
    n_events = len(pf_per_event)
    if n_max is None:
        n_max = max((len(ev["pt"]) for ev in pf_per_event), default=0)
    out = np.full((len(PF_FIELDS), n_events, n_max), PAD, dtype=np.float32)
    for e, ev in enumerate(pf_per_event):
        n = min(len(ev["pt"]), n_max)
        for f, field in enumerate(PF_FIELDS):
            vals = np.asarray(ev.get(field, np.full(n, PAD)), dtype=np.float32)
            out[f, e, :n] = vals[:n]
    return out


def save_slice(path: str, x: np.ndarray, y: np.ndarray) -> None:
    """Write one npz slice (x: [12, nev, nmax], y: [nev, T])."""
    np.savez(path, x=x, y=y)
