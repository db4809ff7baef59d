"""NanoAOD adapters (the JAX package's ``etl/adapters.py``) — bridge real CMS NanoAOD files into the numpy chunk
model (etl/common.py) via coffea, when installed.

The reference reads NanoAOD over xrootd with
``NanoEventsFactory.from_root(..., schemaclass=NanoAODSchema)``
(reference data_znunu/generate_npz.py:101).  coffea/awkward are optional
here: this module imports lazily and raises a clear error when absent, so
the rest of the ETL (selection, overlap removal, padding — all pure numpy)
stays testable and usable on pre-extracted inputs.
"""

from __future__ import annotations

from typing import Dict, Iterator

_PF_FIELDS = ["pt", "eta", "phi", "d0", "dz", "mass", "puppiWeight",
              "pdgId", "charge", "fromPV", "pvRef", "pvAssocQuality"]
_MET_COLLS = ["GenMET", "MET", "PuppiMET", "DeepMETResponseTune",
              "DeepMETResolutionTune"]


def nanoaod_to_chunks(path: str, events_per_chunk: int = 1000,
                      with_leptons: bool = False) -> Iterator[Dict]:
    """Yield numpy chunks from one NanoAOD ROOT file.  Requires coffea."""
    try:
        from coffea.nanoevents import NanoEventsFactory
        from coffea.nanoevents.schemas import NanoAODSchema
        import awkward as ak
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "coffea/awkward are required to read NanoAOD ROOT files; "
            "install them or feed pre-extracted npz/chunk inputs") from e

    events = NanoEventsFactory.from_root(path,
                                         schemaclass=NanoAODSchema).events()
    n = len(events)
    for lo in range(0, n, events_per_chunk):
        sl = events[lo: lo + events_per_chunk]
        chunk: Dict = {"PFCands": {}, "LHE": {"HT": ak.to_numpy(sl.LHE.HT)}}
        for f in _PF_FIELDS:
            chunk["PFCands"][f] = [ak.to_numpy(v) for v in sl.PFCands[f]]
        for coll in _MET_COLLS:
            c = getattr(sl, coll)
            chunk[coll] = {"pt": ak.to_numpy(c.pt), "phi": ak.to_numpy(c.phi)}
        if with_leptons:
            chunk["Muon"] = {
                f: [ak.to_numpy(v) for v in sl.Muon[f]]
                for f in ["pt", "eta", "phi", "tightId", "pfRelIso03_all"]}
            chunk["Electron"] = {
                f: [ak.to_numpy(v) for v in sl.Electron[f]]
                for f in ["pt", "eta", "phi", "mvaFall17V1Iso_WP80"]}
        yield chunk
