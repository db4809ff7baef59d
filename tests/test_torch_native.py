"""The port's native binding (deepmetv2_tpu_torch/utils/native.py) and the
artifact bytes it closes (ROADMAP C2), against the JAX package's
``utils/native.py``, ``utils/lz4f.py`` and ``utils/artifacts.py`` on the
same inputs: ``artifacts.save`` writes equal bytes in both packages for
the object in ``ckpts_syn/best.resolutions`` and for a dict of numpy
arrays, and each file loads in both; xxh32, block compression and
``pack_events`` equal the JAX binding's.  The sources are only read;
everything is written into ``tmp_path``.

The packer and the numpy route of ``data/ingest.py`` agree bitwise except
in px = pt·cos φ and py = pt·sin φ, where the C library's ``cosf``/``sinf``
and numpy's float32 cos/sin may round to neighbouring floats, which the
product with pt carries to at most 2 ulp (the same holds between the JAX
package's two routes).  Each route equals the JAX package's same route
bitwise.
"""

import os.path as osp
import re

import numpy as np
import pytest

from deepmetv2_tpu.data import ingest as j_ingest
from deepmetv2_tpu.utils import artifacts as j_artifacts
from deepmetv2_tpu.utils import lz4f as j_lz4f
from deepmetv2_tpu.utils import native as j_native
from deepmetv2_tpu_torch.data import ingest as t_ingest
from deepmetv2_tpu_torch.utils import artifacts as t_artifacts
from deepmetv2_tpu_torch.utils import lz4f as t_lz4f
from deepmetv2_tpu_torch.utils import native as t_native

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    """Both bindings load here (the toolchain is in the image): the byte
    contract is the compressed frame's."""
    assert j_native.available() and t_native.available()


def _objects():
    rng = np.random.default_rng(0)
    return {
        "resolutions": t_artifacts.load(osp.join(REPO, "ckpts_syn",
                                                 "best.resolutions")),
        "arrays": {"w": rng.normal(size=(64, 3)).astype(np.float32),
                   "idx": np.arange(500, dtype=np.int64),
                   "mask": rng.random(100) < 0.5},
    }


@pytest.mark.parametrize("name", ["resolutions", "arrays"])
def test_artifacts_save_writes_the_jax_package_bytes(name, tmp_path):
    obj = _objects()[name]
    jp, tp = tmp_path / "jax.pkl", tmp_path / "port.pkl"
    j_artifacts.save(obj, str(jp))
    t_artifacts.save(obj, str(tp))
    assert jp.read_bytes() == tp.read_bytes()
    # the frame holds compressed blocks: the native compressor ran
    assert len(tp.read_bytes()) < len(t_lz4f.decompress_frame(
        tp.read_bytes()))
    for load in (j_artifacts.load, t_artifacts.load):
        for path in (jp, tp):
            got = load(str(path))
            if name == "arrays":
                for k, v in obj.items():
                    np.testing.assert_array_equal(got[k], v)
            else:
                assert got.keys() == obj.keys()


def test_xxh32_and_blocks_match_the_jax_binding():
    rng = np.random.default_rng(1)
    for n in (0, 1, 15, 16, 17, 1000, 70000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert t_native.xxh32(data) == j_native.xxh32(data)
        assert t_native.xxh32(data, 7) == j_native.xxh32(data, 7)
        assert t_native.xxh32(data) == t_lz4f.xxh32(data)
    for data in (b"the quick brown fox " * 400,
                 rng.integers(0, 4, 5000, dtype=np.uint8).tobytes(),
                 rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()):
        comp = t_native.lz4_compress_block(data)
        assert comp == j_native.lz4_compress_block(data)
        if comp is not None:
            assert t_native.lz4_decompress_block(comp, len(data)) == data
            assert t_lz4f._decompress_block_py(comp) == data
            assert t_lz4f.decompress_block(comp) == data


def test_frame_roundtrip_through_both_packages():
    data = b"".join(np.arange(300000, dtype=np.int32).tobytes()
                    for _ in range(20))        # several 4 MB blocks
    frame = t_lz4f.compress_frame(data)
    assert frame == j_lz4f.compress_frame(data)
    assert j_lz4f.decompress_frame(frame) == data
    assert t_lz4f.decompress_frame(frame) == data


def test_pack_events_matches_the_jax_packer_and_numpy():
    rng = np.random.default_rng(2)
    nev, nmax = 5, 40
    raw = rng.normal(scale=50, size=(12, nev, nmax)).astype(np.float32)
    raw[7] = rng.choice([11.0, 22.0, -999.0, 211.0], size=(nev, nmax))
    raw[8, 0, :5] = -999.0
    raw[3, 1, 3] = np.nan
    raw[4, 2, 4] = np.inf
    raw[0, 3, 2] = 1e6                  # px, py beyond the clip
    out, lengths = t_native.pack_events(raw)
    jout, jlengths = j_native.pack_events(raw)
    np.testing.assert_array_equal(lengths, jlengths)
    np.testing.assert_array_equal(out, jout)
    for e in range(nev):
        _assert_routes_agree(out[e, :lengths[e]],
                             t_ingest.event_from_raw(raw[:, e]))


def _assert_routes_agree(packed, numpy_route):
    """Bitwise but px, py, within 2 ulp (module docstring)."""
    np.testing.assert_array_equal(packed[:, 2:], numpy_route[:, 2:])
    np.testing.assert_array_max_ulp(packed[:, :2], numpy_route[:, :2], 2)


def test_npz_ingest_native_route_gives_the_numpy_arrays(tmp_path,
                                                        monkeypatch):
    rng = np.random.default_rng(3)
    raw = rng.normal(scale=20, size=(12, 6, 30)).astype(np.float32)
    raw[7, :, 20:] = -999.0
    y = rng.normal(size=(6, 11)).astype(np.float32)
    path = str(tmp_path / "slice.npz")
    np.savez(path, x=raw, y=y)
    native_route = list(t_ingest.load_npz_events(path))
    jax_route = list(j_ingest.load_npz_events(path))
    monkeypatch.setattr(t_native, "pack_events", lambda *a, **k: None)
    monkeypatch.setattr(j_native, "pack_events", lambda *a, **k: None)
    numpy_route = list(t_ingest.load_npz_events(path))
    jax_numpy_route = list(j_ingest.load_npz_events(path))
    assert len(native_route) == len(numpy_route) == len(jax_route) == 6
    for (a, ya), (b, yb), (c, _), (d, _) in zip(
            native_route, numpy_route, jax_route, jax_numpy_route):
        np.testing.assert_array_equal(a, c)        # the packers
        np.testing.assert_array_equal(b, d)        # the numpy routes
        _assert_routes_agree(a, b)
        np.testing.assert_array_equal(ya, yb)


def test_library_built_from_the_checkout_with_the_makefile_flags():
    """The library lives under build/native/, never in native/, and is
    compiled with native/Makefile's CXXFLAGS."""
    path = t_native.library_path()
    assert path.parent == t_native.BUILD_DIR and path.exists()
    make = open(osp.join(REPO, "native", "Makefile")).read()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", make, re.M).group(1).split()
    assert tuple(flags) == t_native.CXXFLAGS
