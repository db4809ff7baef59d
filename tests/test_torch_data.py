"""The port's host data layer against the JAX package: byte-equal events,
batches (eta- and cell-presorted included), split indices, eta
permutations, halos and spans."""

import numpy as np
import pytest
import torch

import deepmetv2_tpu.data.batching as jb
import deepmetv2_tpu.data.loader as jl
import deepmetv2_tpu.data.sorting as js
from deepmetv2_tpu.data.synthetic import synthetic_events as j_synth
from deepmetv2_tpu_torch.data import batching as tb
from deepmetv2_tpu_torch.data import loader as tl
from deepmetv2_tpu_torch.data import sorting as ts
from deepmetv2_tpu_torch.data.synthetic import synthetic_events as t_synth


def _same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,kw", [(0, {}), (42, {}),
                                     (5, dict(n_min=3, n_max=40,
                                              target_dim=6))])
def test_synthetic_events_byte_equal(seed, kw):
    je, te = j_synth(7, seed=seed, **kw), t_synth(7, seed=seed, **kw)
    assert len(je) == len(te)
    for (jx, jy), (tx, ty) in zip(je, te):
        _same_arrays(jx, tx)
        _same_arrays(jy, ty)


@pytest.mark.parametrize("kw", [dict(buckets=(64, 128, 256)),
                                dict(buckets=(128,), pad_events_to=9),
                                dict(pad_to=200)])
def test_collate_byte_equal(kw):
    events = t_synth(6, seed=3, n_min=10, n_max=150)
    jbat = jb.collate(events, **kw)
    tbat = tb.collate(events, **kw)
    for f in jb.EventBatch._fields:
        _same_arrays(getattr(jbat, f), getattr(tbat, f))
    _same_arrays(jb.pad_batch_events(jbat, 12).mask,
                 tb.pad_batch_events(tbat, 12).mask)


@pytest.mark.parametrize("n,n_val,seed", [(2000, 400, 42), (100, 20, 42),
                                          (37, 0, 7)])
def test_split_indices_equal(n, n_val, seed):
    jt, jv = jl._torch_random_split_indices(n, n_val, seed)
    tt, tv = tl._torch_random_split_indices(n, n_val, seed)
    _same_arrays(jt, tt)
    _same_arrays(jv, tv)


@pytest.mark.parametrize("mode", ["sequential", "bucketed"])
def test_loader_batches_byte_equal(mode):
    events = t_synth(30, seed=1, n_min=10, n_max=300)
    kw = dict(events=events, batch_size=4, buckets=(128, 256, 512),
              mode=mode)
    jls, tls = jl.fetch_dataloader(**kw), tl.fetch_dataloader(**kw)
    for split in ("train", "test"):
        jbs, tbs = list(jls[split]), list(tls[split])
        assert len(jbs) == len(tbs)
        for jbat, tbat in zip(jbs, tbs):
            for f in jb.EventBatch._fields:
                _same_arrays(getattr(jbat, f), getattr(tbat, f))


@pytest.mark.parametrize("mode,presort", [("sequential", "cell"),
                                          ("bucketed", "cell"),
                                          ("sequential", "eta")])
def test_presorted_loader_batches_and_halo_equal(mode, presort):
    events = t_synth(30, seed=6, n_min=10, n_max=500)
    kw = dict(events=events, batch_size=4, buckets=(128, 256, 512),
              mode=mode, presort_eta=True, presort_mode=presort,
              presort_r=0.4)
    jls, tls = jl.fetch_dataloader(**kw), tl.fetch_dataloader(**kw)
    for split in ("train", "test"):
        assert (jls[split].required_halo(0.4)
                == tls[split].required_halo(0.4))
        jbs, tbs = list(jls[split]), list(tls[split])
        assert len(jbs) == len(tbs)
        for jbat, tbat in zip(jbs, tbs):
            for f in jb.EventBatch._fields:
                _same_arrays(getattr(jbat, f), getattr(tbat, f))


@pytest.mark.parametrize("block_rows", [None, 64, 96])
def test_cell_sort_and_spans_equal(block_rows):
    events = t_synth(5, seed=7, n_min=30, n_max=700)
    batch = tb.collate(events, buckets=(1024,), pad_events_to=6)
    assert js.auto_block_rows(batch, 0.4) == ts.auto_block_rows(batch, 0.4)
    jc = js.cell_sort_batch(batch, r=0.4, block_rows=block_rows)
    tc = ts.cell_sort_batch(batch, r=0.4, block_rows=block_rows)
    for f in jb.EventBatch._fields:
        _same_arrays(getattr(jc, f), getattr(tc, f))
    for r in (0.4, 0.8):
        assert (js.required_span_blocks(jc, r, block_rows)
                == ts.required_span_blocks(tc, r, block_rows))
        assert js.required_span_batch(jc, r) == ts.required_span_batch(tc, r)
        eta, mask = tc.x_cont[..., 3], tc.mask
        phi = np.arctan2(tc.x_cont[..., 1], tc.x_cont[..., 0])
        assert (js.required_span_arrays(eta, phi, mask, r)
                == ts.required_span_arrays(eta, phi, mask, r))


def test_sort_by_eta_permutation_equal():
    events = t_synth(5, seed=2, n_min=20, n_max=250)
    batch = tb.collate(events, buckets=(256,))
    # ties: duplicate some etas inside each event
    batch.x_cont[:, 10:20, 3] = batch.x_cont[:, 0:1, 3]
    jsorted, jperm = js.sort_by_eta(jb.EventBatch(*batch))
    tsorted, tperm = ts.sort_by_eta(tb.to_device(batch, "cpu"))
    _same_arrays(np.asarray(jperm).astype(np.int64), tperm.numpy())
    for f in ("x_cont", "x_cat", "mask"):
        _same_arrays(getattr(jsorted, f), getattr(tsorted, f).numpy())
    host = ts.presort_batch(batch)
    for f in ("x_cont", "x_cat", "mask"):
        _same_arrays(getattr(host, f), getattr(tsorted, f).numpy())


@pytest.mark.parametrize("r", [0.4, 0.8])
def test_required_halo_equal(r):
    events = t_synth(6, seed=4, n_min=20, n_max=400)
    batch = tb.collate(events, buckets=(512,))
    assert js.required_halo(batch, r) == ts.required_halo(batch, r)
    assert (js.required_halo_arrays(batch.x_cont[..., 3], batch.mask, r)
            == ts.required_halo_arrays(batch.x_cont[..., 3], batch.mask, r))
    assert (js.required_halo_events(events, r)
            == ts.required_halo_events(events, r))


def test_npz_ingest_equal(tmp_path):
    from deepmetv2_tpu.data import ingest as ji
    from deepmetv2_tpu.data.synthetic import synthetic_npz
    from deepmetv2_tpu_torch.data import ingest as ti

    path = str(tmp_path / "slice.npz")
    synthetic_npz(path, 5, seed=3, n_max_pad=300)
    raw = np.load(path)["x"]
    for i in range(5):   # the numpy transform: byte-equal
        _same_arrays(ji.event_from_raw(raw[:, i]), ti.event_from_raw(raw[:, i]))
    # the JAX package may take its native packer here (its own cos/sin)
    je, te = list(ji.load_npz_events(path)), list(ti.load_npz_events(path))
    assert len(je) == len(te) == 5
    for (jx, jy), (tx, ty) in zip(je, te):
        np.testing.assert_allclose(jx, tx, rtol=1e-6, atol=1e-6)
        _same_arrays(jy, ty)
    assert ti.discover_npz(str(tmp_path)) == ji.discover_npz(str(tmp_path))
    ds = tl.METDataset(data_dir=str(tmp_path))
    assert len(ds) == 5


def test_to_device_keeps_dtypes():
    batch = tb.collate(t_synth(2, seed=0, n_min=5, n_max=9), buckets=(16,))
    dev = tb.to_device(batch, "cpu")
    assert [t.dtype for t in dev] == [torch.float32, torch.int32, torch.bool,
                                      torch.float32, torch.int32]
    for f in tb.EventBatch._fields:
        _same_arrays(getattr(batch, f), getattr(dev, f).numpy())
