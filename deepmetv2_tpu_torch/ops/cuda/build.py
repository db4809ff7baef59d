"""Build the package's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``BUILD_DIR/lib<name>-<digest>.so``
(``build/kernels/`` in the checkout unless ``utils/cache.py`` points it
elsewhere; the digest covers the sources and the flags, so an edit
rebuilds).  ``build()`` starts one ``nvcc`` per source at once and waits for
all of them.  Nothing is built at import: the first call that needs a
kernel builds it.

Each wrapper that launches a kernel counts its launches in its own
``launches`` attribute (``counted``); ``launch_counts`` reads them all, and
a captured CUDA graph (train/chain.py) adds its captured launches at every
replay with ``add_launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
BUILD_DIR = DEFAULT_BUILD_DIR     # utils/cache.py:enable_compilation_cache
KERNELS = ("window_max", "knn_und", "edge_mlp", "cat_embed", "pn_edge",
           "cut_match")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, Callable] = {}
_counted: Dict[str, Callable] = {}


def counted(fn: Callable) -> Callable:
    """Register the kernel wrapper ``fn``, whose ``launches`` attribute
    (set to 0 here) it raises by one where it launches its kernel."""
    fn.launches = 0
    _counted[fn.__name__] = fn
    return fn


def launch_counts() -> Dict[str, int]:
    """Every registered wrapper's ``launches``, by name."""
    return {name: fn.launches for name, fn in _counted.items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by wrapper name) to the wrappers' ``launches``."""
    for name, n in counts.items():
        _counted[name].launches += n


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Dict]:
    """Compile every kernel in ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns for each compiled kernel
    its ``ptxas`` report (``log``: registers, shared memory, spills) and
    the wall seconds from the start until its ``nvcc`` was seen to end
    (``seconds``; the builds are awaited in order, so a short one may be
    counted until a longer one before it ended); raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)       # atomic: concurrent builders agree
        reports[name] = {"log": log, "seconds": time.perf_counter() - t0}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]


def function(lib: str, name: str, argtypes: Sequence) -> Callable:
    """The C function ``name`` of kernel library ``lib`` (built first if
    needed), returning an int (a CUDA error code for a launch)."""
    key = f"{lib}.{name}"
    if key not in _fns:
        fn = getattr(load(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def launch(fn: Callable, device, *args) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream and raise
    if the launch failed."""
    import torch

    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def on_cpu(name: str, t) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False
