"""CMS-like particle-flow events for every cell, from one traffic file.

The candidate distribution is the one of the NanoAOD-shaped chunks the
port's ETL was driven with at CMS event sizes, written here as the
benchmark's own code: per event ``integers(lo, hi + 1)`` candidates; eta a
core of N(0, sigma) clipped to +-eta_max for ``core_share`` of them, the
rest uniform in +-eta_max; phi uniform; pt Pareto (alpha from pt_min) by
its inverse CDF; |pdgId| from the classes GraphMET embeds, charged ones
signed; fromPV 0-3; the five MET collections uniform in pt and phi, LHE HT
uniform.

Events come out in the layout the port reads from an ETL'd npz slice
after ingest (``x [n, 11]``: px, py, pt, eta, d0, dz, mass, puppiWeight,
pdgId, charge, fromPV; ``y [11]``: genMET, pfMET, PuppiMET, DeepMET
response and resolution as (x, y) pairs, then HT), so the ETL is not part
of a run.

Every seed does the same work: the number of candidates of each event is
a fixed plan drawn from ``plan_seed`` and grouped into batches once; the
run's seed draws the candidates, the targets and the order of the events
inside each batch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Event = Tuple[np.ndarray, np.ndarray]

CLIP = 5000.0          # ingest clips every feature to +-5000


def n_events(traffic: dict) -> int:
    """Events the traffic draws: the training set or the inference pool."""
    return int(traffic["events"])


def size_plan(traffic: dict) -> np.ndarray:
    """Candidates per event, the same for every seed: drawn from
    ``plan_seed`` with ``integers(min, max + 1)``."""
    c = traffic["candidates"]
    rng = np.random.default_rng(int(traffic["plan_seed"]))
    return rng.integers(int(c["min"]), int(c["max"]) + 1,
                        size=n_events(traffic)).astype(np.int64)


def seed_rng(seed: int) -> np.random.Generator:
    """numpy's generator for a run's seed (any whole number)."""
    return np.random.default_rng(int(seed) % (1 << 63))


def make_events(traffic: dict, seed: int) -> List[Event]:
    """The traffic's events for ``seed``: the plan's sizes, each batch's
    events in an order drawn from the seed, every candidate drawn in bulk."""
    sizes = size_plan(traffic)
    batch = int(traffic["batch"])
    rng = seed_rng(seed)
    order = np.concatenate([s + rng.permutation(min(batch, len(sizes) - s))
                            for s in range(0, len(sizes), batch)])
    sizes = sizes[order]
    x = candidates(traffic["candidates"], int(sizes.sum()), rng)
    y = targets(traffic["targets"], len(sizes), rng)
    cuts = np.cumsum(sizes)[:-1]
    return list(zip(np.split(x, cuts), y))


def candidates(c: dict, total: int, rng: np.random.Generator) -> np.ndarray:
    """``total`` candidates ``[total, 11]`` float32 in the ingest layout,
    every column drawn in float32 in one call."""
    f32 = np.float32
    emax = f32(c["eta_max"])
    x = np.empty((total, 11), f32)
    core = rng.random(total, dtype=f32) < f32(c["core_share"])
    eta = rng.standard_normal(total, dtype=f32) * f32(c["core_sigma"])
    np.clip(eta, -emax, emax, out=eta)
    flat = rng.random(total, dtype=f32) * (2 * emax) - emax
    x[:, 3] = np.where(core, eta, flat)
    phi = rng.random(total, dtype=f32) * f32(2 * np.pi) - f32(np.pi)
    pt = f32(c["pt_min"]) * (f32(1) - rng.random(total, dtype=f32)) ** f32(
        -1.0 / float(c["pt_alpha"]))
    x[:, 0] = pt * np.cos(phi)
    x[:, 1] = pt * np.sin(phi)
    x[:, 2] = pt
    classes = c["pdg_classes"]
    pdgs = np.array([k["pdg"] for k in classes], f32)
    charged = np.array([k["charged"] for k in classes], f32)
    mass = np.array([k["mass"] for k in classes], f32)
    cum = np.cumsum([k["share"] for k in classes])[:-1].astype(f32)
    cls = np.searchsorted(cum, rng.random(total, dtype=f32), side="right")
    sign = (2 * rng.integers(0, 2, total, dtype=np.int8) - 1).astype(f32)
    x[:, 4] = rng.standard_normal(total, dtype=f32) * f32(c["d0_sigma"])
    x[:, 5] = rng.standard_normal(total, dtype=f32) * f32(c["dz_sigma"])
    x[:, 6] = mass[cls]
    x[:, 7] = rng.random(total, dtype=f32)
    x[:, 8] = pdgs[cls] * np.where(charged[cls] == 1, sign, f32(1))
    x[:, 9] = charged[cls] * -sign
    x[:, 10] = rng.integers(0, int(c["from_pv_max"]) + 1, total,
                            dtype=np.int8)
    return np.clip(x, -CLIP, CLIP, out=x)


def targets(t: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``[n, 11]``: the five MET collections as (x, y), then HT."""
    y = np.zeros((n, 11), np.float32)
    for k in range(5):
        pt = rng.uniform(0.0, float(t["met_pt_max"]), n)
        phi = rng.uniform(-np.pi, np.pi, n)
        y[:, 2 * k] = pt * np.cos(phi)
        y[:, 2 * k + 1] = pt * np.sin(phi)
    y[:, 10] = rng.uniform(*map(float, t["ht"]), n)
    return y


def batches(events: List[Event], batch: int) -> List[List[Event]]:
    """The events in consecutive batches of ``batch`` (the last may be
    shorter)."""
    return [events[i:i + batch] for i in range(0, len(events), batch)]
