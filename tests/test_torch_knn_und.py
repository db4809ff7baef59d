"""The port's fused kNN graph build (ops/knn_und.py, the plain versions of
the csrc/knn_und.cu kernels) and its coarsening matching
(ops/dyn_graph.py, ops/coarsen.py) against the JAX package, whose Pallas
kernels run in interpret mode.

Tolerances: both packages sum d² = |a|²+|b|²−2a·b in f32 in other orders,
and the subtraction cancels, so t and the listed d² agree to 2·sqrt(H) ulps
of |a|²+|b|² (plus rtol 1e-6).  Neighbour lists, masks and the relation are
equal, except that on random data a pair whose distance lies within that
tolerance of a threshold may be decided either way: a test allows a stated
number of such rows and holds every other row exactly.  Matchings are
identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.ops import coarsen as jc
from deepmetv2_tpu.ops import dyn_graph as jdg
from deepmetv2_tpu.ops.pallas.knn_und import knn_und_graph as j_knn
from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops import coarsen as tc
from deepmetv2_tpu_torch.ops import dyn_graph as tdg
from deepmetv2_tpu_torch.ops import knn_und as tk
from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph as t_knn
from tests.torch_threads import few_torch_threads  # noqa: F401

RTOL = 1e-6


def _canon(idx, mask):
    """Per-row ascending ids with empty slots last (slot order is
    ascending d² in both packages; ids make ties order-free)."""
    return np.sort(np.where(np.asarray(mask), np.asarray(idx), 1 << 30),
                   axis=-1)


def _gaussian(B, N, H, seed, pad=True):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    n_valid = (rng.integers(N - N // 4, N, size=B) if pad
               else np.full(B, N))
    mask = np.arange(N)[None, :] < n_valid[:, None]
    return np.where(mask[..., None], h, 0.0).astype(np.float32), mask


def _both(h, mask, k, cap):
    """(JAX outputs, port outputs) as numpy: nbr idx, mask, d2v, t, rel."""
    jn, jd, jt, jr = j_knn(jnp.asarray(h), jnp.asarray(mask), k=k, cap=cap,
                           interpret=True, want_rel=True)
    tn, td, tt, tr = t_knn(torch.as_tensor(h), torch.as_tensor(mask), k=k,
                           cap=cap, want_rel=True)
    j = dict(idx=np.asarray(jn.idx), mask=np.asarray(jn.mask),
             d2v=np.asarray(jd), t=np.asarray(jt), rel=np.asarray(jr) > 0)
    t = dict(idx=tn.idx.numpy(), mask=tn.mask.numpy(), d2v=td.numpy(),
             t=tt.numpy(), rel=tr.numpy())
    return j, t


def _ulp_tol(h):
    """``[B, N, N]`` tolerance of a d² value: 2·sqrt(H) ulps of sq_i + sq_j.
    The packages sum |a|² + |b|² − 2a·b over H features in other orders
    (the port one term at a time, XLA in its own); each sum's rounding
    error grows like sqrt(H) ulps, and the subtraction cancels, so a d²
    differs by ulps of the sums, not of itself (measured up to 1.5 of
    them, at H=64)."""
    sq = (h.astype(np.float64) ** 2).sum(-1)
    return 2.0 ** -22 * np.sqrt(h.shape[-1]) * (sq[:, :, None]
                                                + sq[:, None, :])


def _boundary(h, t_ref):
    """``[B, N, N]``: pairs whose relation decision (d² <= t_i or <= t_j)
    lies within ``_ulp_tol`` of a threshold, where summation order may
    decide it either way."""
    d = h.astype(np.float64)
    d2 = ((d[:, :, None, :] - d[:, None, :, :]) ** 2).sum(-1)
    tol = _ulp_tol(h)
    return ((np.abs(d2 - t_ref[:, :, None]) <= tol)
            | (np.abs(d2 - t_ref[:, None, :]) <= tol))


def _assert_same_graph(j, t, h, mask, max_rows=0):
    """The port's graph equals JAX's on real query rows (``mask``; the JAX
    kernels leave padded query rows undefined).  With ``max_rows`` > 0, up
    to that many rows may differ, each only through relation pairs on a
    threshold boundary (``_boundary``); every other row is held exactly."""
    tol = _ulp_tol(h)
    B, N, _ = tol.shape
    fin = np.isfinite(j["t"]) & mask
    np.testing.assert_array_equal(np.isfinite(t["t"])[mask],
                                  np.isfinite(j["t"])[mask])
    t_tol = tol.max(axis=2)
    assert np.all(np.abs(t["t"][fin] - j["t"][fin]) <= t_tol[fin])
    rel_off = (t["rel"] != j["rel"]) & mask[:, :, None]
    assert np.all(_boundary(h, j["t"])[rel_off]), "a non-boundary pair differs"
    rows = (rel_off.any(-1)
            | (_canon(t["idx"], t["mask"]) != _canon(j["idx"], j["mask"]))
            .any(-1) | (t["mask"] != j["mask"]).any(-1))
    assert rows.sum() <= max_rows, np.argwhere(rows)
    assert not (rows & ~rel_off.any(-1)).any(), "a list differs by itself"
    same = ~rows
    np.testing.assert_array_equal(t["mask"][same], j["mask"][same])
    np.testing.assert_array_equal(_canon(t["idx"], t["mask"])[same],
                                  _canon(j["idx"], j["mask"])[same])
    assert t["idx"].dtype == np.int32
    assert np.all(t["idx"][~t["mask"]] == 0)
    np.testing.assert_array_equal(np.isinf(t["d2v"]), ~t["mask"])
    m = t["mask"] & same[..., None]
    # the listed d² of slot (b, i, s) against its own pair's tolerance
    slot_tol = np.take_along_axis(tol, np.where(m, t["idx"], 0), axis=2)
    order = np.argsort(np.where(t["mask"], t["idx"], N), axis=-1)
    jorder = np.argsort(np.where(j["mask"], j["idx"], N), axis=-1)
    td = np.take_along_axis(t["d2v"], order, -1)
    jd = np.take_along_axis(j["d2v"], jorder, -1)
    ms = np.take_along_axis(m, order, -1)
    st = np.take_along_axis(slot_tol, order, -1)
    assert np.all(np.abs(td[ms] - jd[ms]) <= st[ms] + RTOL * np.abs(jd[ms]))


@pytest.mark.parametrize("N", [128, 256])
@pytest.mark.parametrize("H", [8, 64])
@pytest.mark.parametrize("k", [4, 16])
def test_knn_und_matches_jax(N, H, k):
    h, mask = _gaussian(2, N, H, seed=N + H + k)
    j, t = _both(h, mask, k, 32)
    _assert_same_graph(j, t, h, mask, max_rows=2)
    # slots in ascending d² order, the relation symmetric on real rows
    d = np.where(t["mask"], t["d2v"], np.inf)
    assert np.all(d[..., 1:] >= d[..., :-1])
    vv = mask[:, :, None] & mask[:, None, :]
    assert np.array_equal(t["rel"] & vv, np.swapaxes(t["rel"], 1, 2) & vv)


def test_knn_und_hub_truncates_at_cap():
    """One node at the origin is near every node: its relation row holds
    far more than ``cap`` nodes, its list the nearest ``cap`` of them."""
    B, N, H, k, cap = 1, 128, 8, 4, 8
    rng = np.random.default_rng(1)
    u = rng.normal(size=(B, N, H))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = rng.uniform(1.0, 2.0, size=(B, N, 1))
    h = (u * r).astype(np.float32)
    h[:, 0] = 0.0
    mask = np.ones((B, N), bool)
    j, t = _both(h, mask, k, cap)
    _assert_same_graph(j, t, h, mask, max_rows=2)
    assert t["rel"][0, 0].sum() > cap and t["mask"][0, 0].sum() == cap
    related = np.flatnonzero(t["rel"][0, 0])
    nearest = related[np.argsort((h[0, related].astype(np.float64) ** 2)
                                 .sum(-1))][:cap]
    np.testing.assert_array_equal(np.sort(t["idx"][0, 0]), np.sort(nearest))


def test_knn_und_lattice_ties():
    """Integer features: many exactly equal distances, every d² exact in
    both packages, so ties at the k-th neighbour and at the cap resolve by
    the same rule (ascending index)."""
    rng = np.random.default_rng(2)
    h = rng.integers(-2, 3, size=(2, 128, 4)).astype(np.float32)
    mask = np.ones((2, 128), bool)
    mask[1, 100:] = False
    j, t = _both(h, mask, 6, 16)
    _assert_same_graph(j, t, h, mask)
    np.testing.assert_array_equal(t["idx"], j["idx"])   # slot order too
    assert (t["rel"].sum(-1) > 16).any()                # rows past the cap


def test_knn_und_empty_and_tiny_events():
    rng = np.random.default_rng(7)
    h = rng.normal(size=(2, 128, 4)).astype(np.float32)
    mask = np.zeros((2, 128), bool)
    mask[1, :3] = True   # event 0 empty; event 1 has 3 < k nodes
    j, t = _both(h, mask, 4, 8)
    _assert_same_graph(j, t, h, mask)
    assert not t["mask"][0].any()
    assert np.all(np.isinf(t["t"][1]))       # fewer than k valid sources
    deg = t["mask"][1].sum(-1)
    assert (deg[:3] == 2).all() and (deg[3:] == 0).all()


def test_knn_und_compacted_size():
    """N=1536, the second round's capacity after compaction."""
    h, mask = _gaussian(2, 1536, 64, seed=5)
    j, t = _both(h, mask, 16, 32)
    _assert_same_graph(j, t, h, mask, max_rows=4)


def test_plain_d2_is_symmetric_and_sequential():
    """d²(i,j) == d²(j,i) bit for bit; duplicates are at exactly 0."""
    rng = np.random.default_rng(3)
    h = torch.as_tensor(rng.normal(size=(64, 16)).astype(np.float32))
    h[5] = h[9]
    sq = tk.sq_norms(h[None])[0]
    d2 = tk.event_d2(h, sq)
    assert torch.equal(d2, d2.T)
    assert float(d2[5, 9]) == 0.0
    # the ascending one-rounding-at-a-time sum, checked by hand on a row
    ref = np.float32(0.0)
    for c in range(16):
        ref = np.float32(ref + np.float32(h[3, c] * h[7, c]))
    want = np.maximum(np.float32(sq[3] + sq[7]) - np.float32(2.0) * ref, 0)
    assert float(d2[3, 7]) == float(want)


def test_unsupported_shape_raises():
    h = torch.zeros((1, 100, 8))
    with pytest.raises(NotImplementedError, match="composed path"):
        tdg.build_dyn_graph(h, torch.ones((1, 100), dtype=torch.bool), k=4)


def _mask(kind, B, N, rng):
    """Node masks: ``prefix`` (each event's first nodes), ``scattered``
    (about 60 % valid with random gaps), ``empty`` (event 0 has no node),
    ``tiny`` (event 0 has 3 scattered nodes, fewer than k + 1)."""
    if kind == "prefix":
        return np.arange(N)[None, :] < rng.integers(N // 2, N, size=B)[:, None]
    mask = rng.random((B, N)) < 0.6
    if kind == "empty":
        mask[0] = False
    elif kind == "tiny":
        mask[0] = False
        mask[0, [5, 40, 77]] = True
    return mask


@pytest.mark.parametrize("kind", ["prefix", "scattered", "empty", "tiny"])
def test_padded_rows_are_defined(kind):
    """A padded query row gets t = +inf, every slot index 0 with d² +inf,
    and an all-false relation row, from the plain versions and through the
    wrapper (the kernels write the same, chip_smoke.py)."""
    rng = np.random.default_rng(21)
    B, N, H, k, cap = 3, 128, 8, 4, 8
    h = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32))
    mask = torch.as_tensor(_mask(kind, B, N, rng))
    pad = ~mask
    t, sq = tk.knn_kth_torch(h, mask, k)
    idx, d2v, rel = tk.knn_extract_torch(h, mask, t, sq, cap, True)
    assert torch.isposinf(t[pad]).all()
    assert (idx[pad] == 0).all() and torch.isposinf(d2v[pad]).all()
    assert not rel[pad].any()
    assert torch.equal(sq, tk.sq_norms(h))        # every row's norm
    # real rows with k sources keep members; no row names a padded node
    full = (mask.sum(-1) > k)[:, None] & mask
    assert torch.isfinite(d2v[full]).any(-1).all()
    assert not (rel & pad[:, None, :]).any()
    nbr, d2n, tt, rr = t_knn(h, mask, k=k, cap=cap, want_rel=True)
    assert torch.equal(tt, t) and torch.equal(rr, rel)
    assert not nbr.mask[pad].any()


def _event_reference(h, mask, k, cap):
    """Each event cut down to its real nodes, its graph built from
    ``event_d2`` of that cut alone, and the ids mapped back: ``(t, idx,
    d2v, rel)`` of the real rows, in the layout of the plain versions."""
    B, N, _ = h.shape
    inf = float("inf")
    t = torch.full((B, N), inf)
    idx = torch.zeros((B, N, cap), dtype=torch.int32)
    d2v = torch.full((B, N, cap), inf)
    rel = torch.zeros((B, N, N), dtype=torch.bool)
    for b in range(B):
        ids = torch.nonzero(mask[b])[:, 0]
        n = len(ids)
        if n == 0:
            continue
        hb = h[b, ids]
        d2 = tk.event_d2(hb, tk.sq_norms(hb[None])[0])
        off = ~torch.eye(n, dtype=torch.bool)
        d2m = torch.where(off, d2, torch.tensor(inf))
        tb = (torch.kthvalue(d2m, k, dim=-1).values if k <= n
              else torch.full((n,), inf))
        u = ((d2 <= tb[:, None]) | (d2 <= tb[None, :])) & off
        vals, order = torch.sort(torch.where(u, d2, torch.tensor(inf)),
                                 dim=-1, stable=True)
        m = min(cap, n)
        vals, order = vals[:, :m], order[:, :m]
        got = torch.isfinite(vals)
        t[b, ids] = tb
        d2v[b, ids, :m] = torch.where(got, vals, torch.tensor(inf))
        idx[b, ids, :m] = torch.where(got, ids[order],
                                      torch.zeros_like(order)).to(torch.int32)
        rel[b, ids[:, None], ids[None, :]] = u
    return t, idx, d2v, rel


@pytest.mark.parametrize("N,H,k,cap", [(128, 8, 4, 8), (256, 64, 16, 32)])
def test_real_rows_ignore_padded_nodes(N, H, k, cap):
    """On scattered masks the plain versions' real rows equal, bit for bit,
    the graph of each event cut down to its real nodes: leaving padded
    sources (and rows) out moves no real row."""
    rng = np.random.default_rng(N + k)
    B = 3
    h = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32))
    mask = torch.as_tensor(_mask("tiny", B, N, rng))
    t, sq = tk.knn_kth_torch(h, mask, k)
    idx, d2v, rel = tk.knn_extract_torch(h, mask, t, sq, cap, True)
    want = _event_reference(h, mask, k, cap)
    for what, got, ref in zip(("t", "idx", "d2v", "rel"),
                              (t, idx, d2v, rel), want):
        assert torch.equal(got, ref), what
    assert torch.isfinite(t[1:][mask[1:]]).all()   # real thresholds exist


# ------------------------------------------------------ coarsen, dyn_graph


def _pair(rng, B, N, H, frac=0.9):
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    mask = rng.random((B, N)) < frac
    return h, mask


def test_argmax_takes_the_first_maximum():
    w = torch.tensor([[0.0, 3.0, 1.0, 3.0, 3.0]])
    assert int(torch.argmax(w, dim=-1)) == 1
    assert int(jnp.argmax(jnp.asarray(w.numpy()), axis=-1)[0]) == 1


def test_dense_matching_pool_and_global_pool_match_jax():
    rng = np.random.default_rng(11)
    B, N, H = 2, 128, 8
    h, mask = _pair(rng, B, N, H)
    W = rng.random((B, N, N)).astype(np.float32)
    W = np.where(rng.random((B, N, N)) < 0.1, W, -np.inf)
    W = np.maximum(W, np.swapaxes(W, 1, 2))
    W[:, np.arange(N), np.arange(N)] = -np.inf
    W[:, :4, :4] = np.where(np.isfinite(W[:, :4, :4]), 0.5, -np.inf)  # ties
    jcl, jpa = jc.handshake_matching_dense(jnp.asarray(W), jnp.asarray(mask))
    tcl, tpa = tc.handshake_matching_dense(torch.as_tensor(W),
                                           torch.as_tensor(mask))
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))
    np.testing.assert_array_equal(tpa.numpy(), np.asarray(jpa))
    jp, jm = jc.max_pool(jnp.asarray(h), jcl, jpa, jnp.asarray(mask))
    tp, tm = tc.max_pool(torch.as_tensor(h), tcl, tpa, torch.as_tensor(mask))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    tm = tm.clone()
    tm[1] = False                                    # an empty event
    np.testing.assert_array_equal(
        tc.global_max_pool(tp, tm).numpy(),
        np.asarray(jc.global_max_pool(jp, jnp.asarray(tm.numpy()))))


def test_list_matching_and_cut_weights_match_jax():
    from deepmetv2_tpu.data.batching import Neighborhood as JNbr

    rng = np.random.default_rng(12)
    h, mask = _pair(rng, 2, 128, 8)
    j, t = _both(np.where(mask[..., None], h, 0).astype(np.float32), mask,
                 4, 16)
    jn = JNbr(idx=jnp.asarray(j["idx"]), mask=jnp.asarray(j["mask"]))
    tn = Neighborhood(torch.as_tensor(j["idx"]), torch.as_tensor(j["mask"]))
    hp = rng.normal(size=h.shape).astype(np.float32)
    jw = jc.normalized_cut_weights(jnp.asarray(hp), jn)
    tw = tc.normalized_cut_weights(torch.as_tensor(hp), tn)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    jcl, jpa = jc.handshake_matching(jw, jn, jnp.asarray(mask))
    tcl, tpa = tc.handshake_matching(tw, tn, torch.as_tensor(mask))
    np.testing.assert_array_equal(tpa.numpy(), np.asarray(jpa))
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))


def test_cut_matching_dense_branch_matches_jax():
    """The dense branch fed each package's own relation (equal, as the
    graph tests show) and post-conv features."""
    rng = np.random.default_rng(13)
    h, mask = _pair(rng, 2, 256, 16)
    h = np.where(mask[..., None], h, 0).astype(np.float32)
    hp = rng.normal(size=h.shape).astype(np.float32)
    jg = jdg.build_dyn_graph(jnp.asarray(h), jnp.asarray(mask), k=6,
                             force="fused", interpret=True)
    tg = tdg.build_dyn_graph(torch.as_tensor(h), torch.as_tensor(mask), k=6)
    assert tg.rel is not None and tg.rel.dtype == torch.bool
    jcl, jpa = jdg.cut_matching(jg, jnp.asarray(hp), jnp.asarray(mask))
    tcl, tpa = tdg.cut_matching(tg, torch.as_tensor(hp),
                                torch.as_tensor(mask))
    np.testing.assert_array_equal(tpa.numpy(), np.asarray(jpa))
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))


@pytest.mark.parametrize("tile_c", [128, 256])
def test_tiled_cut_weights_match_jax(tile_c):
    """The N > 4096 branch's weight matrix, called directly at small N on
    integer features (every d² exact, so the JAX package's recomputed
    relation equals the extraction's), against the JAX package's."""
    rng = np.random.default_rng(5)
    B, N, H = 2, 256, 16
    h0 = rng.integers(-8, 8, size=(B, N, H)).astype(np.float32)
    hp = rng.integers(-8, 8, size=(B, N, H)).astype(np.float32)
    mask = rng.random((B, N)) < 0.95
    g = tdg.build_dyn_graph(torch.as_tensor(h0), torch.as_tensor(mask), k=4)
    jW = jdg._tiled_cut_weights(jnp.asarray(h0), jnp.asarray(g.t.numpy()),
                                jnp.asarray(hp), jnp.asarray(mask), tile_c)
    tW = tdg._tiled_cut_weights(g.rel, torch.as_tensor(hp), tile_c)
    np.testing.assert_array_equal(np.isfinite(tW.numpy()),
                                  np.isfinite(np.asarray(jW)))
    np.testing.assert_allclose(tW.numpy(), np.asarray(jW), rtol=1e-6)
    # and the whole tiled branch gives the rel branch's matching
    want = tdg.cut_matching(g, torch.as_tensor(hp), torch.as_tensor(mask))
    got = tc.handshake_matching_dense(tW, torch.as_tensor(mask))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("tile_c", [128, 256])
@pytest.mark.parametrize("frac", [1.0, 0.9])
def test_tiled_branch_reads_the_extraction_relation(tile_c, frac,
                                                    monkeypatch):
    """On normal (non-integer) features, where a d² recomputed in another
    summation order can fall an ulp past a row's threshold: with
    DENSE_MATCH_MAX_N lowered below N, the graph build still hands over
    the extraction's ``rel`` bit for bit, and the matching on its column
    tiles equals the one on the whole weight matrix, with all rows real and
    with a 90 % mask (padded rows zero in ``rel``, masked by the
    matching)."""
    rng = np.random.default_rng(21)
    B, N, H = 2, 512, 64
    h = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32))
    mask_t = torch.as_tensor(rng.random((B, N)) < frac)
    hp = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32))
    g = tdg.build_dyn_graph(h, mask_t, k=16)
    assert g.rel is not None and int(g.rel.sum()) > 0
    assert not g.rel[~mask_t].any() and not g.rel.transpose(1, 2)[~mask_t].any()
    want = tdg.cut_matching(g, hp, mask_t)
    monkeypatch.setattr(tdg, "DENSE_MATCH_MAX_N", 128)
    monkeypatch.setattr(tdg, "DENSE_TILE_C", tile_c)
    g_tiled = tdg.build_dyn_graph(h, mask_t, k=16)
    assert torch.equal(g_tiled.rel, g.rel)
    got = tdg.cut_matching(g_tiled, hp, mask_t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_graph_build_emits_rel_where_the_matching_is_dense():
    """The extraction hands its relation over wherever the dense matching
    runs: up to DENSE_MATCH_MAX_N nodes, and above it while B·N² is within
    DENSE_W_MAX_ELEMS (the tiled branch); past that the list matching
    needs none."""
    assert tdg.dense_matching(40, 2048)
    assert tdg.dense_matching(8, 8192)             # a batch of 8 at 8192
    assert tdg.dense_matching(1, 4096 + 128)
    assert not tdg.dense_matching(9, 8192)
    assert not tdg.dense_matching(2, 65536)


def test_cut_matching_ignores_padded_rel_rows():
    """The dense matching masks query rows itself: random garbage in the
    padded rows of ``rel`` gives the same matching as the zero rows the
    graph build writes."""
    import dataclasses

    rng = np.random.default_rng(14)
    B, N, H = 2, 256, 16
    h, mask = _pair(rng, B, N, H, frac=0.6)
    h = torch.as_tensor(np.where(mask[..., None], h, 0).astype(np.float32))
    mask = torch.as_tensor(mask)
    hp = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32))
    g = tdg.build_dyn_graph(h, mask, k=6)
    assert not g.rel[~mask].any()
    junk = g.rel.clone()
    junk[~mask] = torch.as_tensor(rng.random((int((~mask).sum()), N)) < 0.5)
    want = tdg.cut_matching(g, hp, mask)
    got = tdg.cut_matching(dataclasses.replace(g, rel=junk), hp, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
