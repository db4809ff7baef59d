"""Z→νν ETL (the JAX package's ``etl/znunu.py``) — reference data_znunu/generate_npz.py:95-153 semantics.

Invisible-decay samples: no lepton selection or recoil correction — the
targets are the straight MET flavors (px, py) plus LHE HT; all PF
candidates are padded and saved in 1000-event slices.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from deepmetv2_tpu_torch.etl import common

EVENTS_PER_SLICE = 1000  # reference data_znunu/generate_npz.py:95


def process_chunk_znunu(chunk: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Process one chunk → (x [12, nev, nmax], y [nev, 11])."""
    n_events = len(chunk["PFCands"]["pt"])

    def xy(coll):
        pt = np.asarray(chunk[coll]["pt"], np.float64)
        phi = np.asarray(chunk[coll]["phi"], np.float64)
        return pt * np.cos(phi), pt * np.sin(phi)

    y = np.empty((n_events, 11), np.float32)
    y[:, 0], y[:, 1] = xy("GenMET")
    y[:, 2], y[:, 3] = xy("MET")
    y[:, 4], y[:, 5] = xy("PuppiMET")
    y[:, 6], y[:, 7] = xy("DeepMETResponseTune")
    y[:, 8], y[:, 9] = xy("DeepMETResolutionTune")
    y[:, 10] = np.asarray(chunk["LHE"]["HT"], np.float32)

    pf = [{k: np.asarray(v[e]) for k, v in chunk["PFCands"].items()}
          for e in range(n_events)]
    x = common.pad_particle_list(pf)
    return x, y
