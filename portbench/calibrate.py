"""The readings a cell's limits are set from, many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--seconds 2] [--control] [--fault <name>]

For each seed: the cell's run (set-up, a short window, the check) and one
JSON line with its compared numbers.  ``--control`` puts the cell's
lower-precision control in the program's place; ``--fault`` plants a
fault under the timed path (faults.py: unchanged, not_captured,
half_batch, altered, no_matching).  The lower reading of a number is
the largest over a dozen seeds of sound runs; the upper one the smallest
of the control's (and, in a training cell, of each fault's) readings.
PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench import faults, spec
    from portbench.run import run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    from deepmetv2_tpu_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache(str(ROOT / "build" / "kernels"))
    cell_spec = spec.cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        plant = (faults.plant(args.fault) if args.fault
                 else contextlib.nullcontext())
        with plant:
            outcome, result = run_cell(cell_spec, seed, args.seconds, False,
                                       "cuda", args.control, t0)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": args.control, "fault": args.fault,
            "correct": result["correct"],
            "readings": {k: v["value"] for k, v in outcome.checks.items()},
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "seconds": time.perf_counter() - t0,
            "notes": outcome.notes}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
