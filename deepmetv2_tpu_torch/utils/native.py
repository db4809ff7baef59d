"""ctypes binding to the repository's native C++ library
(``native/deepmet_native.cc``), the counterpart of the JAX package's
``utils/native.py``: ``xxh32``, ``lz4_compress_block``,
``lz4_decompress_block`` and ``pack_events``.

The library is compiled from the checkout's ``native/deepmet_native.cc``
with ``g++`` and ``native/Makefile``'s flags, at first use, into
``build/native/`` (``native/`` itself is never written).  The file name
carries a digest of the source and the flags, so an edit rebuilds.

``available()`` is False where no compiler or library can be had, as in the
JAX package.  Its callers then take their pure-Python or numpy routes:
``utils/lz4f.py`` stores every block of a frame uncompressed, which is what
the JAX package's frame writer does without the library (its
``utils/lz4f.py:compress_frame``), so those are the reference's bytes
there; ``data/ingest.py`` packs events with numpy, which gives the same
arrays but in px and py, where numpy's float32 cos and sin and the C
library's may differ by an ulp (2 after the product with pt), in the JAX
package as here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "deepmet_native.cc"
BUILD_DIR = REPO / "build" / "native"
CXX = "g++"
CXXFLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17")  # the Makefile

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX,) + CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdeepmet_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile the library into ``out`` (through a file of this process's
    own, renamed into place, so concurrent builds agree)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([CXX, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.dm_xxh32.restype = ctypes.c_uint32
        lib.dm_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.c_uint32]
        lib.dm_lz4_compress.restype = ctypes.c_int64
        lib.dm_lz4_compress.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_void_p, ctypes.c_int64]
        lib.dm_lz4_decompress.restype = ctypes.c_int64
        lib.dm_lz4_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                          ctypes.c_void_p, ctypes.c_int64]
        lib.dm_pack_events.restype = ctypes.c_int
        lib.dm_pack_events.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def xxh32(data: bytes, seed: int = 0) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    return int(lib.dm_xxh32(data, len(data), seed))


def lz4_compress_block(data: bytes) -> Optional[bytes]:
    """One LZ4 block of ``data``; None without the library, for empty
    input, or where the compressor gives up."""
    lib = _load()
    if lib is None or len(data) == 0:
        return None
    cap = len(data) + len(data) // 128 + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.dm_lz4_compress(data, len(data), out, cap)
    if n <= 0:
        return None
    return out.raw[:n]


def lz4_decompress_block(data: bytes, max_size: int) -> Optional[bytes]:
    """The decoded block, at most ``max_size`` bytes; None without the
    library, or when the block is corrupt or does not fit."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(max_size)
    n = lib.dm_lz4_decompress(data, len(data), out, max_size)
    if n < 0:
        return None
    return out.raw[:n]


def pack_events(raw: np.ndarray, clip: float = 5000.0
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """A whole ETL slice ``raw [12, nev, nmax]`` → ``(out [nev, nmax, 11]
    float32, lengths [nev] int32)``: px, py derived, pad rows dropped,
    nan_to_num and the clip, as ``data/ingest.py:event_from_raw``.  None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.float32)
    if raw.ndim != 3 or raw.shape[0] != 12:
        raise ValueError(f"expected a [12, nev, nmax] slice, got {raw.shape}")
    _, nev, nmax = raw.shape
    out = np.zeros((nev, nmax, 11), dtype=np.float32)
    lengths = np.zeros((nev,), dtype=np.int32)
    rc = lib.dm_pack_events(
        raw.ctypes.data_as(ctypes.c_void_p), nev, nmax, ctypes.c_float(clip),
        out.ctypes.data_as(ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"dm_pack_events returned {rc}")
    return out, lengths
