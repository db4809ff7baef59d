"""NPZ ingest — the JAX package's ``data/ingest.py`` contract
(reference model/data_loader.py:63-90).

* raw feature order: pt, eta, phi, d0, dz, mass, puppiWeight, pdgId, charge,
  fromPV, pvRef, pvAssocQuality;
* derived order: px, py, pt, eta, d0, dz, mass, puppiWeight, pdgId, charge,
  fromPV  (px = pt·cos phi, py = pt·sin phi);
* rows with pdgId == -999 or charge == -999 (ETL pad fill) are dropped;
* nan_to_num, then clip to ±5000.

A whole slice is packed by the native C++ packer (utils/native.py) when
the library is available, else event by event in numpy, as in the JAX
package; the two give the same arrays but in px and py, which may differ
by up to 2 ulp (the C library's cos and sin against numpy's).
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import Iterator, List, Tuple

import numpy as np

from deepmetv2_tpu_torch.utils import native

RAW_PT, RAW_ETA, RAW_PHI = 0, 1, 2
RAW_D0, RAW_DZ, RAW_MASS, RAW_PUPPI = 3, 4, 5, 6
RAW_PDGID, RAW_CHARGE, RAW_FROMPV = 7, 8, 9

CLIP = 5000.0
PAD_FILL = -999.0


def event_from_raw(raw: np.ndarray, clip: float = CLIP) -> np.ndarray:
    """One raw event ``[12, n_max]`` (features first, the ETL slice layout)
    → the 11-feature layout without pad rows."""
    raw = np.asarray(raw, dtype=np.float32)
    if raw.ndim != 2 or raw.shape[0] != 12:
        raise ValueError(f"expected a [12, n] raw event, got {raw.shape}")
    raw = raw.T  # [n_max, 12]

    pt, eta, phi = raw[:, RAW_PT], raw[:, RAW_ETA], raw[:, RAW_PHI]
    x = np.empty((raw.shape[0], 11), dtype=np.float32)
    x[:, 0] = pt * np.cos(phi)   # px
    x[:, 1] = pt * np.sin(phi)   # py
    x[:, 2] = pt
    x[:, 3] = eta
    x[:, 4:11] = raw[:, RAW_D0:RAW_FROMPV + 1]  # d0,dz,mass,puppi,pdg,charge,fromPV

    keep = (x[:, 8] != PAD_FILL) & (x[:, 9] != PAD_FILL)
    x = x[keep]

    x = np.nan_to_num(x)
    np.clip(x, -clip, clip, out=x)
    return x


def load_npz_events(path: str) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(x [n, 11], y [T])`` per event of one npz slice
    (``x``: [12, n_events, n_max]; ``y``: [n_events, T])."""
    with np.load(path, allow_pickle=True) as f:
        xs = np.asarray(f["x"], dtype=np.float32)
        ys = np.asarray(f["y"], dtype=np.float32)
    packed = native.pack_events(xs, clip=CLIP)
    if packed is not None:
        out, lengths = packed
        for ievt in range(xs.shape[1]):
            yield out[ievt, :lengths[ievt]].copy(), ys[ievt, :]
        return
    for ievt in range(xs.shape[1]):
        yield event_from_raw(xs[:, ievt, :]), ys[ievt, :]


def discover_npz(data_dir: str) -> List[str]:
    """Sorted raw npz slice files (``<dir>/raw/*.npz``, else ``<dir>/*.npz``)."""
    raw_dir = osp.join(data_dir, "raw")
    if osp.isdir(raw_dir):
        return sorted(glob.glob(osp.join(raw_dir, "*.npz")))
    return sorted(glob.glob(osp.join(data_dir, "*.npz")))
