"""Synthetic particle-flow events, the JAX package's ``data/synthetic.py``.

Same numpy generator, same draws in the same order: one seed gives the
same events in both packages.  Each event has a hard-scatter subset
(fromPV==3, puppiWeight ~ 1) whose negative vector sum is genMET, diluted
with pileup (fromPV<3, puppiWeight ~ 0), in the ingest contract's
11-feature layout.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# |pdgId| classes (reference model/graph_met_network.py:45) with charges.
_PDG_CHOICES = np.array([11, 13, 22, 130, 211, 1, 2], dtype=np.int32)
_PDG_CHARGED = np.array([1, 1, 0, 0, 1, 0, 0], dtype=np.int32)
_PDG_PROBS = np.array([0.02, 0.02, 0.25, 0.13, 0.50, 0.04, 0.04])


def synthetic_events(
    n_events: int,
    seed: int = 0,
    n_min: int = 50,
    n_max: int = 1500,
    target_dim: int = 11,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n_events`` events as ``(x [n, 11], y [target_dim])``; y is
    [genMETx, genMETy, pfMETx, pfMETy, puppiMETx, puppiMETy,
    deepRespMETx, deepRespMETy, deepResoMETx, deepResoMETy, HT]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_events):
        n = int(rng.integers(n_min, n_max + 1))

        pt = rng.pareto(2.5, size=n).astype(np.float32) * 2.0 + 0.3
        eta = rng.uniform(-5.0, 5.0, size=n).astype(np.float32)
        phi = rng.uniform(-np.pi, np.pi, size=n).astype(np.float32)

        cls = rng.choice(len(_PDG_CHOICES), size=n, p=_PDG_PROBS)
        pdg = _PDG_CHOICES[cls] * rng.choice([-1, 1], size=n)
        charged = _PDG_CHARGED[cls]
        charge = (charged * rng.choice([-1, 1], size=n)).astype(np.int32)

        # hard scatter vs pileup: ~35% of candidates from the primary vertex
        is_hs = rng.random(n) < 0.35
        from_pv = np.where(is_hs, 3, rng.integers(0, 3, size=n)).astype(np.int32)
        puppi = np.clip(
            np.where(is_hs, rng.normal(0.95, 0.05, n), rng.normal(0.05, 0.05, n)),
            0.0, 1.0,
        ).astype(np.float32)

        d0 = rng.normal(0.0, np.where(is_hs, 0.01, 0.1), n).astype(np.float32)
        dz = rng.normal(0.0, np.where(is_hs, 0.02, 5.0), n).astype(np.float32)
        mass = np.where(np.abs(pdg) == 211, 0.13957,
                        np.where(np.abs(pdg) == 130, 0.49761, 0.0)).astype(np.float32)

        px = pt * np.cos(phi)
        py = pt * np.sin(phi)

        x = np.stack(
            [px, py, pt, eta, d0, dz, mass, puppi,
             pdg.astype(np.float32), charge.astype(np.float32),
             from_pv.astype(np.float32)],
            axis=1,
        ).astype(np.float32)

        # genMET balances the hard-scatter system (plus smearing)
        hs_px = float(np.sum(px[is_hs]))
        hs_py = float(np.sum(py[is_hs]))
        gen = np.array([-hs_px, -hs_py]) + rng.normal(0, 1.0, 2)

        y = np.zeros((target_dim,), dtype=np.float32)
        # loss convention (reference model/net.py:60): (MET + y)^2 with
        # MET = sum w p, so y[0:2] holds the genMET components
        y[0:2] = gen
        if target_dim >= 6:
            y[2:4] = gen + rng.normal(0, 12.0, 2)   # pfMET
            y[4:6] = gen + rng.normal(0, 7.0, 2)    # puppiMET
        if target_dim >= 10:
            y[6:8] = gen + rng.normal(0, 5.0, 2)    # DeepMETResponse
            y[8:10] = gen + rng.normal(0, 4.5, 2)   # DeepMETResolution
        if target_dim >= 11:
            y[10] = float(np.sum(pt[is_hs]))        # LHE HT proxy
        out.append((x, y))
    return out
