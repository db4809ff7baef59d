"""What the kernel probes share: variants of a kernel source built side by
side, CUDA-event timing, the GPU check and the card's closing line."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from deepmetv2_tpu_torch.ops.cuda import build

# variant -> (old, new) text replacements in one csrc/ source
Variants = Dict[str, List[Tuple[str, str]]]


def variant_source(stem: str, variants: Variants, name: str) -> str:
    """``csrc/<stem>.cu`` with variant ``name``'s replacements; raises if
    one no longer matches the source exactly once."""
    src = (build.CSRC / f"{stem}.cu").read_text()
    for old, new in variants[name]:
        if src.count(old) != 1:
            raise ValueError(f"{stem} probe: variant {name}: its cut "
                             f"{old.strip()[:50]!r} does not match the source")
        src = src.replace(old, new)
    return src


def build_variants(stem: str, variants: Variants) -> Dict[str, Path]:
    """Compile every variant of ``csrc/<stem>.cu`` into
    ``build/kernels/probe/``, one ``nvcc`` each, all at once."""
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in variants:
        cu = out_dir / f"{stem}_{name}.cu"
        cu.write_text(variant_source(stem, variants, name))
        lib = out_dir / f"lib{stem}_{name}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{stem} probe: {name} failed to build:\n{log}")
        libs[name] = lib
    return libs


def ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def cuda_device(probe: str) -> Optional[torch.device]:
    """``cuda:0``, made current; None, with a line on stderr, without a
    CUDA GPU."""
    if not torch.cuda.is_available():
        print(f"{probe}: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return None
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    return device


def print_device() -> None:
    """The probe's last line: the card's name, and its name and power limit
    as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
