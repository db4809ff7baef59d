"""The port's benchmark: one cell of ``BENCHMARK.json`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell's entry (``entries/<entry>.py``, the traffic file's
``entry``) with its family (``families/<family>.py``, the configuration
file's ``family``) on ``deepmetv2_tpu_torch``, its configuration and
traffic read from the files ``BENCHMARK.json`` names, then judges what the
timed path produced against the plain reference (``reference/``) and
prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks`` (each compared number
with its limit, also the last lines of standard error).  Without a CUDA card it exits with code 2 and prints no
result; it never falls back to the CPU.  ``--control`` runs the cell's
lower-precision control in the program's place, which has to come out
not correct.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "deepmetv2_tpu")


def loaded_forbidden() -> list:
    """Modules in this process whose top-level name is JAX's, Flax's or
    the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not readable"


def run_cell(cell_spec, seed: int, seconds: float, trace: bool, device,
             control: bool = False, t0: float = T0):
    """Run one cell on ``device``; returns ``(outcome, result line)``."""
    import torch

    from portbench import cell, spec

    entry = spec.entry(cell_spec.traffic["entry"])
    r = cell.Run(cell_spec, seed, seconds, trace, torch.device(device), t0,
                 control)
    outcome = entry.run(r)
    metrics = spec.read_metrics(
        cell_spec.per_layer if trace else cell_spec.end_to_end,
        outcome.reading)
    dev = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(r.device)
                    if r.device.type == "cuda" else "cpu"),
           "count": cell_spec.chips,
           "memory_peak_bytes": outcome.memory_peak}
    if trace and outcome.reading.trace_window_s:
        dev["busy_s"] = outcome.reading.busy_s or 0.0
        dev["window_s"] = outcome.reading.trace_window_s
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": dev}
    if trace and outcome.breakdown:
        result["breakdown"] = outcome.breakdown
    result["checks"] = outcome.checks
    return outcome, result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the lower-precision control in the program's "
                        "place (it has to come out not correct)")
    args = p.parse_args(argv)

    from portbench import spec

    cell_spec = spec.cell_spec(args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell_spec.chips):
        print(f"portbench: {args.workload} needs {cell_spec.chips} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()}); no result",
              file=sys.stderr)
        return 2
    # the CLIs' precision (cli/common.py:resolve_device): no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    from deepmetv2_tpu_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache(str(ROOT / "build" / "kernels"))
    print(f"portbench: card {card_line()}", file=sys.stderr)
    outcome, result = run_cell(cell_spec, args.seed, args.seconds,
                               bool(args.trace), "cuda", args.control)
    for note in outcome.notes:
        print(f"portbench: {note}", file=sys.stderr)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {bad}; no result",
              file=sys.stderr)
        return 3
    for name, c in outcome.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
