"""The port's NanoAOD ETL (``deepmetv2_tpu_torch/etl/``) and its kernel
cache (``utils/cache.py``) against the JAX package's, on the CPU.

Every ETL function is held bitwise to its JAX counterpart on seeded
inputs: the chunks come from ``chip_smoke.etl_chunk`` (numpy only) at 12
events of 50–300 candidates, the size of the tests.  The slices both CLIs
write are compared by name and array; they then go through both packages'
``METDataset`` (bitwise) and both evaluate CLIs with ``ckpts_syn``'s
weights (losses within rtol 1e-5, as ``test_torch_serve.py`` holds the
synthetic ones: both compute in f32 but sum in other orders).  The
full-size chunks of the smoke test's ``etl_data`` phase go through the
port's ETL and must give ``chip_smoke.GOLDEN_ETL_DIGESTS`` and, through the
port's CLI sizing, ``GOLDEN_ETL_HALO`` and ``GOLDEN_ETL_TRAIN_HALO``.

Helpers that are not tests recompute the goldens with the JAX package:
``jax_etl_digests()`` the digests (~2 s), ``jax_etl_eval_loss()`` the
JAX evaluate CLI's loss and halo on the full-size slices
(``GOLDEN_ETL_LOSS``, ``GOLDEN_ETL_HALO``; ~50 s), and
``jax_etl_resume_losses(10)`` its train steps from ``ckpts_syn/best.ckpt``
on the first 10 cell-sorted train batches (``GOLDEN_ETL_TRAIN_LOSSES``
and ``GOLDEN_ETL_TRAIN_HALO``; ~8 min, and ~40 GB of host memory: XLA
keeps every window chunk's residuals for the backward at N=8192);
``port_etl_resume_losses(10)`` is the port's CPU run of the same steps
(~2.5 min).
"""

import contextlib
import io
import itertools
import os
import os.path as osp
import pickle
import shutil
import tempfile

import numpy as np
import pytest

import chip_smoke
from deepmetv2_tpu.etl import common as j_common
from deepmetv2_tpu.etl import dytt as j_dytt
from deepmetv2_tpu.etl import generate_npz as j_gen
from deepmetv2_tpu.etl import znunu as j_znunu
from deepmetv2_tpu_torch.etl import common as t_common
from deepmetv2_tpu_torch.etl import dytt as t_dytt
from deepmetv2_tpu_torch.etl import generate_npz as t_gen
from deepmetv2_tpu_torch.etl import znunu as t_znunu
from tests.torch_threads import few_torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CKPTS = osp.join(REPO, "ckpts_syn")
SMALL_PF = (50, 301)
f32 = np.float32


def _same(a, b):
    """Bitwise equal arrays of one dtype and shape."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def write_chunks(d, n_pf=chip_smoke.ETL_PF, sizes=None):
    """``chip_smoke.ETL_CHUNKS`` (or the same modes at ``sizes`` events)
    drawn by ``chip_smoke.etl_chunk`` and pickled into ``d``: (dytt
    paths, znunu paths)."""
    os.makedirs(d, exist_ok=True)
    paths = {"dytt": [], "znunu": []}
    for i, (mode, n) in enumerate(chip_smoke.ETL_CHUNKS):
        p = osp.join(d, f"chunk{i}.pkl")
        with open(p, "wb") as f:
            pickle.dump(chip_smoke.etl_chunk(
                chip_smoke.ETL_SEED + i, sizes or n, mode == "dytt", n_pf), f)
        paths[mode].append(p)
    return paths["dytt"], paths["znunu"]


def run_etl(gen, chunks, out):
    """Both modes of an ETL CLI module (``gen``) into ``out``/raw, as the
    smoke test runs them; returns its stdout."""
    dytt, znunu = chunks
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        for mode, paths in (("dytt", dytt), ("znunu", znunu)):
            assert gen.main(["--mode", mode, "--input", *paths, "--out",
                             osp.join(out, "raw"), "--dataset", mode]) == 0
    return text.getvalue()


def slice_digests(d):
    """{file name: (digest of x, digest of y)} of the slices in d/raw."""
    raw = osp.join(d, "raw")
    out = {}
    for name in sorted(os.listdir(raw)):
        with np.load(osp.join(raw, name)) as z:
            out[name] = (chip_smoke.etl_array_digest(z["x"]),
                         chip_smoke.etl_array_digest(z["y"]))
    return out


def ckpt_copy(d):
    os.makedirs(d)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(osp.join(CKPTS, f), d)
    return d


# --- helpers that recompute the goldens (not tests) -------------------------

def _jax_full_etl(d):
    """The JAX ETL CLI on the smoke test's chunks, in ``d`` (a new temporary
    directory if None); returns ``(d, data directory)``."""
    d = d or tempfile.mkdtemp(prefix="etl_golden")
    run_etl(j_gen, write_chunks(osp.join(d, "chunks")), osp.join(d, "etl"))
    return d, osp.join(d, "etl")


def jax_etl_digests(d=None):
    """The JAX package's ETL CLI on the smoke test's chunks: the source of
    ``chip_smoke.GOLDEN_ETL_DIGESTS`` (~2 s)."""
    return slice_digests(_jax_full_etl(d)[1])


def jax_etl_eval_loss(d=None):
    """(validation loss, halo) of the JAX evaluate CLI on the smoke test's
    slices with ``ckpts_syn/best.ckpt`` (batch 40, eta order on the
    device, the halo sized on the whole dataset): the source of
    ``chip_smoke.GOLDEN_ETL_LOSS`` and ``GOLDEN_ETL_HALO`` (~50 s)."""
    from deepmetv2_tpu.cli import evaluate as j_eval
    from deepmetv2_tpu.cli.train import apply_graph_mode
    from deepmetv2_tpu.config import Config
    from deepmetv2_tpu.data import fetch_dataloader

    d, data = _jax_full_etl(d)
    ld = fetch_dataloader(data_dir=data, batch_size=40)["test"]
    args = type("Args", (), {"graph_mode": "window"})
    halo = apply_graph_mode(Config(), args, ld.dataset).graph.window_halo
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_eval.main(["--data", data, "--ckpts",
                            ckpt_copy(osp.join(d, "jck"))]) == 0
    return float(out.getvalue().split("validation loss:")[1].split()[0]), halo


def _cell_loaders(loader_mod, data):
    return loader_mod.fetch_dataloader(
        data_dir=data, batch_size=chip_smoke.TRAIN_B, presort_eta=True,
        presort_mode="cell")


def jax_etl_resume_losses(n_steps: int, d=None):
    """(per-step train losses, halo) of the JAX package's train step from
    ``ckpts_syn/best.ckpt`` on the first ``n_steps`` cell-sorted train
    batches of the smoke test's slices (batch 8, the halo its train CLI
    sizes on both loaders): the source of
    ``chip_smoke.GOLDEN_ETL_TRAIN_LOSSES`` and ``GOLDEN_ETL_TRAIN_HALO``
    (~8 min and ~40 GB of host memory for 10), modelled on
    ``tests/test_torch_train.py:jax_resume_losses``."""
    import jax

    from deepmetv2_tpu.cli.train import apply_graph_mode
    from deepmetv2_tpu.config import Config, DataConfig
    from deepmetv2_tpu.data import loader as jl
    from deepmetv2_tpu.models.graph_met import graph_met_init
    from deepmetv2_tpu.train import checkpoint as jck
    from deepmetv2_tpu.train.step import init_train_state, make_train_step

    lds = _cell_loaders(jl, _jax_full_etl(d)[1])
    args = type("Args", (), {"graph_mode": "window"})
    cfg = apply_graph_mode(Config(data=DataConfig(batch_size=8)), args,
                           lds["train"].dataset, presorted=True,
                           loaders=[lds["train"], lds["test"]])
    template = init_train_state(*graph_met_init(jax.random.PRNGKey(0)), cfg)
    state, _ = jck.load_checkpoint(osp.join(CKPTS, "best.ckpt"),
                                   template=template)
    step = make_train_step(cfg)
    losses = []
    for b in itertools.islice(iter(lds["train"]), n_steps):
        state, loss = step(state, b)
        losses.append(float(loss))
    return losses, cfg.graph.window_halo


def port_etl_resume_losses(n_steps: int, d=None):
    """The port's CPU run of ``jax_etl_resume_losses``' steps (its ETL, its
    CLI's halo, its train step one batch at a time; ~2.5 min for 10)."""
    import torch

    from deepmetv2_tpu_torch.cli.common import apply_graph_mode
    from deepmetv2_tpu_torch.config import Config, DataConfig
    from deepmetv2_tpu_torch.data import loader as tl
    from deepmetv2_tpu_torch.data.batching import to_device
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train import step as tstep
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint

    d = d or tempfile.mkdtemp(prefix="etl_port")
    data = osp.join(d, "etl")
    run_etl(t_gen, write_chunks(osp.join(d, "chunks")), data)
    lds = _cell_loaders(tl, data)
    args = type("Args", (), {"graph_mode": "window"})
    cfg = apply_graph_mode(Config(data=DataConfig(batch_size=8)), args,
                           lds["train"].dataset, presorted=True,
                           loaders=[lds["train"], lds["test"]])
    model = GraphMET(cfg.model)
    opt = tstep.make_optimizer(cfg, model)
    restore_checkpoint(osp.join(CKPTS, "best.ckpt"), model, opt)
    step = tstep.make_train_step(cfg)
    return [float(step(model, opt, to_device(b, torch.device("cpu"))))
            for b in itertools.islice(iter(lds["train"]), n_steps)]


# --- common.py --------------------------------------------------------------

def _phis():
    rng = np.random.default_rng(0)
    wrap = np.array([np.pi - 0.05, -np.pi, np.pi, 3.0, -3.1], f32)
    return (np.concatenate([wrap, rng.uniform(-np.pi, np.pi, 200).astype(f32)]),
            np.concatenate([-wrap, rng.uniform(-np.pi, np.pi, 200)
                            .astype(f32)]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_delta_phi_matches_jax_across_the_wrap(dtype):
    a, b = (p.astype(dtype) for p in _phis())
    got = t_common.delta_phi(a, b)
    _same(got, j_common.delta_phi(a, b))
    assert np.all(np.abs(got) <= np.pi + 1e-6)
    assert np.isclose(abs(got[0]), 0.1, atol=1e-6)   # pi - 0.05 to -pi + 0.05


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_delta_r_matches_jax(dtype):
    rng = np.random.default_rng(1)
    a, b = (p.astype(dtype) for p in _phis())
    e1, e2 = (rng.uniform(-5, 5, len(a)).astype(dtype) for _ in range(2))
    _same(t_common.delta_r(e1, a, e2, b), j_common.delta_r(e1, a, e2, b))


def _overlap_case(name):
    rng = np.random.default_rng(2)
    pe = rng.uniform(-3, 3, 400).astype(f32)
    pp = rng.uniform(-np.pi, np.pi, 400).astype(f32)
    le = rng.uniform(-2.4, 2.4, 3).astype(f32)
    lp = rng.uniform(-np.pi, np.pi, 3).astype(f32)
    if name == "no_leptons":
        return pe, pp, le[:0], lp[:0]
    if name == "no_pf":
        return pe[:0], pp[:0], le, lp
    if name == "shared_nearest":
        # two leptons 2e-4 apart whose nearest candidate is the same one
        # (within 1e-3 of both); a second candidate within the radius of
        # the first lepton survives, as only the argmin is dropped
        pe[7], pp[7] = 0.5, 1.0
        pe[8], pp[8] = 0.5 + 8e-4, 1.0
        return pe, pp, np.array([0.5 - 1e-4, 0.5 + 1e-4], f32), \
            np.array([1.0, 1.0], f32)
    pe[3], pp[3] = le[0] + f32(1e-5), lp[0]            # "planted"
    return pe, pp, le, lp


@pytest.mark.parametrize("name", ["no_leptons", "no_pf", "shared_nearest",
                                  "planted"])
def test_overlap_removal_mask_matches_jax(name):
    args = _overlap_case(name)
    got = t_common.overlap_removal_mask(*args)
    _same(got, j_common.overlap_removal_mask(*args))
    dropped = np.flatnonzero(~got).tolist()
    assert dropped == {"no_leptons": [], "no_pf": [], "shared_nearest": [7],
                       "planted": [3]}[name]


@pytest.mark.parametrize("name", ["longest", "n_max_cut", "missing_field",
                                  "empty"])
def test_pad_particle_list_matches_jax(name):
    chunk = chip_smoke.etl_chunk(5, 6, False, SMALL_PF)
    pf = [{k: np.asarray(v[e]) for k, v in chunk["PFCands"].items()}
          for e in range(6)]
    n_max = None
    if name == "n_max_cut":
        n_max = min(len(ev["pt"]) for ev in pf) - 7
    elif name == "missing_field":
        for ev in pf:
            del ev["pvRef"]
    elif name == "empty":
        pf = []
    got = t_common.pad_particle_list(pf, n_max)
    _same(got, j_common.pad_particle_list(pf, n_max))
    if name == "missing_field":
        assert np.all(got[t_common.PF_FIELDS.index("pvRef")] == t_common.PAD)


def test_met_xy_and_constants_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    pt, phi = rng.uniform(0, 200, 50).astype(f32), _phis()[0][:50]
    for got, want in zip(t_common.met_xy(pt, phi), j_common.met_xy(pt, phi)):
        _same(got, want)
    assert t_common.PF_FIELDS == j_common.PF_FIELDS
    assert t_common.PAD == j_common.PAD
    x = rng.normal(size=(12, 3, 5)).astype(f32)
    y = rng.normal(size=(3, 11)).astype(f32)
    t_common.save_slice(str(tmp_path / "t"), x, y)
    j_common.save_slice(str(tmp_path / "j"), x, y)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) == ["x", "y"]
        for k in ("x", "y"):
            _same(t[k], j[k])


# --- dytt.py, znunu.py ------------------------------------------------------

@pytest.mark.parametrize("which", ["muons", "electrons"])
def test_selections_match_jax(which):
    rng = np.random.default_rng(4)
    n = 300
    if which == "muons":
        coll = {"tightId": rng.integers(0, 2, n),
                "pfRelIso03_all": (0.3 * rng.random(n)).astype(f32),
                "pt": (40 * rng.random(n)).astype(f32)}
        got, want = (t_dytt.select_tight_muons(coll),
                     j_dytt.select_tight_muons(coll))
    else:
        coll = {"mvaFall17V1Iso_WP80": rng.integers(0, 2, n),
                "pt": (40 * rng.random(n)).astype(f32)}
        got, want = (t_dytt.select_tight_electrons(coll),
                     j_dytt.select_tight_electrons(coll))
    _same(got, want)
    assert 0 < got.sum() < n


@pytest.mark.parametrize("n_leptons,n_subtract", [(2, 2), (2, 1), (1, 0),
                                                  (4, 2)])
def test_process_chunk_dytt_matches_jax(n_leptons, n_subtract):
    chunk = chip_smoke.etl_chunk(6, 12, True, SMALL_PF)
    x, y = t_dytt.process_chunk_dytt(chunk, n_leptons, n_subtract)
    jx, jy = j_dytt.process_chunk_dytt(chunk, n_leptons, n_subtract)
    _same(x, jx)
    _same(y, jy)
    if n_leptons == 4:     # at most 2 muons and 1 electron: every event cut
        assert x.shape == (12, 0, 0) and y.shape == (0, 11)
    else:
        assert 0 < y.shape[0] <= 12 and x.shape[:2] == (12, y.shape[0])


def test_process_chunk_znunu_matches_jax():
    chunk = chip_smoke.etl_chunk(7, 12, False, SMALL_PF)
    x, y = t_znunu.process_chunk_znunu(chunk)
    jx, jy = j_znunu.process_chunk_znunu(chunk)
    _same(x, jx)
    _same(y, jy)
    assert y.shape == (12, 11) and y.dtype == np.float32
    assert t_znunu.EVENTS_PER_SLICE == j_znunu.EVENTS_PER_SLICE == 1000


# --- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def small_etl(tmp_path_factory):
    """The smoke test's chunk modes at 12 events of 50-300 candidates,
    through both packages' ETL CLIs: (chunks, port dir, JAX dir, port
    stdout, JAX stdout)."""
    base = tmp_path_factory.mktemp("etl")
    chunks = write_chunks(str(base / "chunks"), SMALL_PF, sizes=12)
    t_out = run_etl(t_gen, chunks, str(base / "port"))
    j_out = run_etl(j_gen, chunks, str(base / "jax"))
    return chunks, str(base / "port"), str(base / "jax"), t_out, j_out


def test_cli_writes_the_jax_slices(small_etl):
    _, tdir, jdir, t_out, j_out = small_etl
    assert t_out.replace(tdir, "") == j_out.replace(jdir, "")
    names = sorted(os.listdir(osp.join(tdir, "raw")))
    assert names == sorted(os.listdir(osp.join(jdir, "raw")))
    assert [n.split("_slice")[0] for n in names] == [
        "dytt_file0", "dytt_file1", "znunu_file0"]
    for name in names:
        with np.load(osp.join(tdir, "raw", name)) as t, \
                np.load(osp.join(jdir, "raw", name)) as j:
            for k in ("x", "y"):
                _same(t[k], j[k])


def test_cli_skips_an_empty_slice_as_jax_does(small_etl, tmp_path):
    chunks = small_etl[0]
    outs = []
    for gen, d in ((t_gen, tmp_path / "t"), (j_gen, tmp_path / "j")):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            assert gen.main(["--mode", "dytt", "--input", *chunks[0],
                             "--out", str(d), "--n_leptons", "4"]) == 0
        outs.append((text.getvalue(), os.listdir(d)))
    assert outs[0] == outs[1] == ("", [])


@pytest.mark.parametrize("suffix,error", [(".root", ImportError),
                                          (".txt", ValueError)])
def test_cli_input_errors_match_jax(suffix, error, tmp_path):
    msgs = []
    for gen in (t_gen, j_gen):
        with pytest.raises(error) as e:
            gen.main(["--mode", "znunu", "--input",
                      str(tmp_path / f"in{suffix}"), "--out",
                      str(tmp_path / "out")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_etl_slices_load_as_jax_loads_them(small_etl):
    from deepmetv2_tpu.data import METDataset as JDataset
    from deepmetv2_tpu_torch.data import METDataset as TDataset

    _, tdir, jdir, _, _ = small_etl
    t, j = TDataset(data_dir=tdir), JDataset(data_dir=jdir)
    assert len(t) == len(j) > 30
    for i in range(len(t)):
        _same(t[i][0], j[i][0])
        _same(t[i][1], j[i][1])


def test_evaluate_cli_on_etl_slices_matches_jax(small_etl, tmp_path):
    """ckpts_syn's weights on the ETL'd events: the port's evaluate CLI
    (its "graph mode:" line with the halo and the batches per bucket)
    against the JAX CLI's loss, rtol 1e-5."""
    from deepmetv2_tpu.cli import evaluate as j_eval
    from deepmetv2_tpu_torch.cli import evaluate as t_eval

    _, tdir, jdir, _, _ = small_etl
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_eval.main(["--data", jdir, "--batch_size", "8", "--ckpts",
                            ckpt_copy(str(tmp_path / "j"))]) == 0
    j_loss = float(out.getvalue().split("validation loss:")[1].split()[0])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t_loss = t_eval.run(["--data", tdir, "--batch_size", "8", "--ckpts",
                             ckpt_copy(str(tmp_path / "t")), "--device",
                             "cpu"])["loss"]
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    halo, per, order = chip_smoke.graph_mode(out.getvalue())
    assert order == "eta (device sort)" and halo % 64 == 0
    assert list(per) == ["test"] and sum(per["test"].values()) == 1


def test_train_cli_on_etl_slices_prints_halo_and_buckets(small_etl, tmp_path):
    """The train CLI on the ETL'd slices: its "graph mode:" line holds the
    halo sized on both cell-sorted loaders and each loader's batches per
    bucket."""
    from deepmetv2_tpu_torch.cli import train as t_train
    from deepmetv2_tpu_torch.data import fetch_dataloader

    tdir = small_etl[1]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert t_train.main(["--data", tdir, "--batch_size", "4",
                             "--epochs", "1", "--ckpts", str(tmp_path / "c"),
                             "--device", "cpu"]) == 0
    lds = fetch_dataloader(data_dir=tdir, batch_size=4, presort_eta=True,
                           presort_mode="cell")
    span = max(lds[k].required_halo(0.4) for k in ("train", "test"))
    assert chip_smoke.graph_mode(out.getvalue()) == (
        max(64, -(-span // 64) * 64),
        {"train": lds["train"].batches_per_bucket(),
         "test": lds["test"].batches_per_bucket()}, "cell")
    assert sum(lds["train"].batches_per_bucket().values()) == len(
        lds["train"])


# --- the goldens of the smoke test's etl_data phase -------------------------

def test_golden_etl_digests_and_halos_by_the_port(tmp_path):
    """The port's ETL on the smoke test's full-size chunks writes
    GOLDEN_ETL_DIGESTS (recomputed by jax_etl_digests), and the port's CLI
    sizing of those slices gives GOLDEN_ETL_HALO (evaluate: the whole
    dataset in eta order) and GOLDEN_ETL_TRAIN_HALO (train: both
    cell-sorted loaders at batch 8)."""
    from deepmetv2_tpu_torch.cli.common import apply_graph_mode
    from deepmetv2_tpu_torch.config import Config
    from deepmetv2_tpu_torch.data import fetch_dataloader
    from deepmetv2_tpu_torch.data import loader as tl

    data = str(tmp_path / "etl")
    run_etl(t_gen, write_chunks(str(tmp_path / "chunks")), data)
    assert slice_digests(data) == chip_smoke.GOLDEN_ETL_DIGESTS
    args = type("Args", (), {"graph_mode": "window"})
    ld = fetch_dataloader(data_dir=data, batch_size=40)["test"]
    assert apply_graph_mode(Config(), args, ld.dataset).graph.window_halo \
        == chip_smoke.GOLDEN_ETL_HALO
    lds = _cell_loaders(tl, data)
    cfg = apply_graph_mode(Config(), args, lds["train"].dataset,
                           presorted=True, loaders=[lds["train"],
                                                    lds["test"]])
    assert cfg.graph.window_halo == chip_smoke.GOLDEN_ETL_TRAIN_HALO
    assert max(lds["train"].batches_per_bucket()) == 8192


# --- utils/cache.py ---------------------------------------------------------

@pytest.mark.parametrize("source", ["path", "env", "default"])
def test_compilation_cache_order(source, tmp_path, monkeypatch):
    """Explicit path, then DEEPMETV2_TPU_CACHE, then build/kernels/ in the
    checkout; the kernel builds then use it."""
    from deepmetv2_tpu_torch.ops.cuda import build
    from deepmetv2_tpu_torch.utils.cache import enable_compilation_cache

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    env = tmp_path / "env"
    if source == "default":
        monkeypatch.delenv("DEEPMETV2_TPU_CACHE", raising=False)
    else:
        monkeypatch.setenv("DEEPMETV2_TPU_CACHE", str(env))
    path = str(tmp_path / "explicit") if source == "path" else None
    got = enable_compilation_cache(path)
    want = {"path": path, "env": str(env),
            "default": osp.join(REPO, "build", "kernels")}[source]
    assert got == want and osp.isdir(want)
    assert str(build.BUILD_DIR) == want
    assert str(build.library_path("window_max").parent) == want


def test_compilation_cache_refuses_an_unusable_directory(tmp_path,
                                                         monkeypatch):
    from deepmetv2_tpu_torch.ops.cuda import build
    from deepmetv2_tpu_torch.utils.cache import enable_compilation_cache

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    before = build.BUILD_DIR
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("DEEPMETV2_TPU_CACHE", str(blocker / "kernels"))
    with pytest.raises(OSError):
        enable_compilation_cache()
    assert build.BUILD_DIR == before
