"""A kernel cache that outlives the process, for the command-line entry
points (the JAX package's ``utils/cache.py``).

The JAX package keeps XLA's compiled executables in a persistent
compilation cache, so that an entry point started again does not compile
again.
The port's counterpart is the directory that ``ops/cuda/build.py`` builds
its CUDA kernels into and loads them from (``build.BUILD_DIR``): each
library's file name carries a digest of its sources and ``nvcc`` flags, so
one directory serves every checkout and an edited source is rebuilt.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path


def enable_compilation_cache(path: str | None = None) -> str:
    """Point the kernel builds at a directory and return its path.

    Priority: explicit ``path`` > ``DEEPMETV2_TPU_CACHE`` env var >
    ``build/kernels/`` in the checkout.  The default differs from the JAX
    function's ``~/.cache/deepmetv2_tpu/xla`` on purpose: the kernels are
    built into a directory of the checkout that ``.gitignore`` lists, and
    nothing outside the checkout is written unless asked for.  The
    directory is created; one that cannot be created or written raises
    (``OSError``), with no fallback to another.  Safe to call more than
    once."""
    from deepmetv2_tpu_torch.ops.cuda import build

    chosen = Path(path or os.environ.get("DEEPMETV2_TPU_CACHE")
                  or build.DEFAULT_BUILD_DIR)
    chosen.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryFile(dir=chosen):
        pass                      # raises where the directory is not writable
    build.BUILD_DIR = chosen
    return str(chosen)
