"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds.

At the cells' sizes (40 or 16 events at N=8192, then 6144) the DRN
matches on its neighbour lists; at these it would take the dense matching
on the kNN relation (``ops/dyn_graph.py:dense_matching``), which the
reference's matching check does not model.  So a tiny run sets the dense
matching's size limits to nothing, and takes the cells' list branch."""

import time

from portbench.faults import patched

from portbench import spec
from portbench.run import run_cell

SIZES = {
    "graphmet-train-cms": dict(events=16, batch=4),
    "graphmet-infer-cms": dict(events=12, batch=4, sample_batches=2,
                               sample_from=3),
    "drn-infer-cms": dict(events=8, batch=4, sample_batches=2,
                          sample_from=2),
    "drn-train-cms": dict(events=12, batch=4),
}


def tiny_spec(name: str) -> spec.CellSpec:
    s = spec.cell_spec(name)
    s.traffic["candidates"] = dict(s.traffic["candidates"], min=60, max=240)
    s.traffic.update(SIZES.get(name, {}))
    s.config["data"]["node_buckets"] = [128, 256]
    return s


def run_tiny(name: str, seed: int = 7, control: bool = False,
             trace: bool = False):
    from deepmetv2_tpu_torch.ops import dyn_graph

    with patched(dyn_graph, "DENSE_MATCH_MAX_N", 0), \
            patched(dyn_graph, "DENSE_W_MAX_ELEMS", 0):
        return run_cell(tiny_spec(name), seed, 0.3, trace, "cpu", control,
                        time.perf_counter())
