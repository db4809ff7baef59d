"""ETL CLI (the JAX package's ``etl/generate_npz.py``) — reference
data_{dytt,znunu}/generate_npz.py equivalent.

    python -m deepmetv2_tpu_torch.etl.generate_npz --mode znunu \
        --input file.root --out data_znunu/raw
    python -m deepmetv2_tpu_torch.etl.generate_npz --mode dytt \
        --input file.root --out data_dytt/raw --n_leptons 2

Reads NanoAOD (requires coffea) or pre-extracted chunk pickles, applies the
per-mode selection (etl/dytt.py, etl/znunu.py), writes padded npz slices in
the exact reference layout.  It runs on the host (numpy only).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
from typing import Iterator

from deepmetv2_tpu_torch.etl import common
from deepmetv2_tpu_torch.etl.dytt import process_chunk_dytt
from deepmetv2_tpu_torch.etl.znunu import EVENTS_PER_SLICE, process_chunk_znunu


def _chunks_from_input(path: str, mode: str) -> Iterator:
    if path.endswith(".root"):
        from deepmetv2_tpu_torch.etl.adapters import nanoaod_to_chunks

        yield from nanoaod_to_chunks(path, EVENTS_PER_SLICE,
                                     with_leptons=(mode == "dytt"))
    elif path.endswith((".pkl", ".chunk")):
        with open(path, "rb") as f:
            yield pickle.load(f)
    else:
        raise ValueError(f"unsupported input {path!r} (.root or .pkl)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=["dytt", "znunu"], required=True)
    p.add_argument("--input", required=True, nargs="+",
                   help="NanoAOD .root files or chunk .pkl files")
    p.add_argument("--out", default="raw", help="output directory")
    p.add_argument("--dataset", default="sample")
    p.add_argument("--n_leptons", type=int, default=2)
    p.add_argument("--n_leptons_subtract", type=int, default=2)
    args = p.parse_args(argv)

    assert args.n_leptons >= args.n_leptons_subtract
    os.makedirs(args.out, exist_ok=True)
    for fidx, path in enumerate(args.input):
        for i, chunk in enumerate(_chunks_from_input(path, args.mode)):
            if args.mode == "dytt":
                x, y = process_chunk_dytt(chunk, args.n_leptons,
                                          args.n_leptons_subtract)
            else:
                x, y = process_chunk_znunu(chunk)
            if y.shape[0] == 0:
                continue
            out = osp.join(
                args.out,
                f"{args.dataset}_file{fidx}_slice_{i}_nevent_{y.shape[0]}")
            common.save_slice(out, x, y)
            print(f"wrote {out}.npz  ({y.shape[0]} events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
