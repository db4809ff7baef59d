"""LZ4 frame codec (the JAX package's ``utils/lz4f.py``).

Artifacts (``.ckpt``, ``.resolutions``) are lz4-frame-wrapped pickles
(reference utils.py:32-46).  The frame layer is Python; each block goes
through the native library (utils/native.py) when it is available: the
writer compresses a block where that makes it smaller and stores it
otherwise, the reader decodes with the library and falls back to the
Python decoder.  Without the library every block is stored, as the JAX
package's writer does then, so the frame is that package's bytes either
way.
"""

from __future__ import annotations

import struct

from deepmetv2_tpu_torch.utils import native

MAGIC = 0x184D2204

_P1, _P2, _P3, _P4, _P5 = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393)
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (the frame header checksum)."""
    n = len(data)
    i = 0
    if n >= 16:
        v = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed & _M,
             (seed - _P1) & _M]
        while i <= n - 16:
            for k in range(4):
                lane = struct.unpack_from("<I", data, i + 4 * k)[0]
                v[k] = (_rotl((v[k] + lane * _P2) & _M, 13) * _P1) & _M
            i += 16
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while i <= n - 4:
        h = (h + struct.unpack_from("<I", data, i)[0] * _P3) & _M
        h = (_rotl(h, 17) * _P4) & _M
        i += 4
    while i < n:
        h = (h + data[i] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h


def decompress_block(src: bytes, max_size: int = 1 << 24) -> bytes:
    """LZ4 block decompression: the native decoder with a growing buffer
    (as the JAX package's), else, or where it cannot decode, the Python
    one, which raises a precise error on a corrupt block."""
    if native.available():
        cap = max(4 * len(src), 1 << 16)
        while cap <= max_size * 4:
            out = native.lz4_decompress_block(src, cap)
            if out is not None:
                return out
            cap *= 4
    return _decompress_block_py(src, max_size)


def _decompress_block_py(src: bytes, max_size: int = 1 << 24) -> bytes:
    """LZ4 block decompression in Python (token | literals | offset |
    match)."""
    dst = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        dst += src[i:i + lit_len]
        i += lit_len
        if i >= n:
            break  # the last sequence has no match
        offset = struct.unpack_from("<H", src, i)[0]
        i += 2
        if offset == 0:
            raise ValueError("corrupt lz4 block: zero offset")
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(dst) - offset
        if start < 0:
            raise ValueError("corrupt lz4 block: offset past start")
        for k in range(match_len):  # may overlap: copy byte by byte
            dst.append(dst[start + k])
        if len(dst) > max_size:
            raise ValueError("lz4 block exceeds max size")
    return bytes(dst)


def compress_frame(data: bytes, block_size: int = 4 << 20) -> bytes:
    """A spec-valid LZ4 frame: each block compressed by the native library
    where that makes it smaller, else stored uncompressed."""
    out = bytearray()
    out += struct.pack("<I", MAGIC)
    flg = (1 << 6) | (1 << 5)           # version 01, block-independent
    bd = 7 << 4                          # 4 MB max block size
    desc = bytes([flg, bd])
    out += desc + bytes([(xxh32(desc) >> 8) & 0xFF])
    for i in range(0, len(data), block_size) or [0]:
        chunk = data[i:i + block_size]
        comp = native.lz4_compress_block(chunk)
        if comp is not None and len(comp) < len(chunk):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", len(chunk) | 0x80000000) + chunk
    out += struct.pack("<I", 0)          # end mark
    return bytes(out)


def decompress_frame(buf: bytes) -> bytes:
    """Parse an LZ4 frame and return the decompressed payload."""
    if len(buf) < 7 or struct.unpack_from("<I", buf, 0)[0] != MAGIC:
        raise ValueError("not an lz4 frame")
    flg = buf[4]
    if (flg >> 6) != 1:
        raise ValueError("unsupported lz4 frame version")
    has_content_size = bool(flg & 0x08)
    has_block_checksum = bool(flg & 0x10)
    has_dict_id = bool(flg & 0x01)
    i = 6  # magic + FLG + BD
    if has_content_size:
        i += 8
    if has_dict_id:
        i += 4
    i += 1  # header checksum
    out = bytearray()
    while True:
        bsize = struct.unpack_from("<I", buf, i)[0]
        i += 4
        if bsize == 0:
            break
        uncompressed = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = buf[i:i + bsize]
        i += bsize
        if has_block_checksum:
            i += 4
        out += block if uncompressed else decompress_block(block)
    return bytes(out)
