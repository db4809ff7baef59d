"""The port's window max (the plain PyTorch version of the CUDA kernel)
against JAX ``window_max_xla`` and the Pallas ``window_max`` in interpret
mode: exact equality on real rows, for eta-sorted, clustered (value ties,
pairs on the radius boundary), cell-sorted and padded batches.  The whole
``window_edgeconv_linear`` against JAX's at rtol/atol 1e-5.

The backward: ``window_max_bwd_torch`` against the VJP of the Pallas
``window_max`` in interpret mode on the same cases, ties included (every
tied source gets the full gradient), equal up to the order of the sums
(rtol 1e-6, atol 1e-6 on gradients of O(1)); and the gradients of x, w and
b through the port's EdgeConv against those through
``window_edgeconv_linear_pallas`` at rtol 1e-5 and an atol of 2e-6 of the
largest entry (the gradients of w and b sum over every node, so their
rounding scales with their size).

Padded rows (eta >= PAD_POS / 2): the wrappers' CPU paths give −inf in the
forward and 0 in the backward there, on every case; the kernels' own
threshold constant is PAD_POS / 2, and the wrappers hand the kernels an
8-byte aligned pos.  The kernels' chunk
prune, ``window_chunks_needed``: every adjacent pair lies in a needed
chunk (exhaustively on every case; by ``hypothesis`` with boxes exactly r,
and one ulp either side of r, apart, where the prune must be exact), and
a window max and backward that visit only needed chunks, the kernels'
loop in plain torch, equal the plain versions bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deepmetv2_tpu.data import collate
from deepmetv2_tpu.data.sorting import (cell_sort_batch, required_halo,
                                        required_span_batch, sort_by_eta)
from deepmetv2_tpu.ops.pallas import edgeconv_window as jpal
from deepmetv2_tpu.ops.window import WindowGraph as JWindowGraph
from deepmetv2_tpu.ops.window import window_edgeconv_linear as j_wecl
from deepmetv2_tpu.ops.window import window_max_xla
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.ops.cuda import edgeconv_window as tcu
from deepmetv2_tpu_torch.ops.edgeconv import edgeconv
from deepmetv2_tpu_torch.ops.window import (PAD_POS, WindowGraph, adjacent,
                                            padded_rows,
                                            window_chunks_needed,
                                            window_edgeconv_linear,
                                            window_max_bwd_torch,
                                            window_max_torch)
from tests.torch_threads import few_torch_threads  # noqa: F401

R2 = 0.4 ** 2


def _etaphi(batch):
    phi = np.arctan2(np.asarray(batch.x_cont[..., 1]),
                     np.asarray(batch.x_cont[..., 0]))
    return np.stack([np.asarray(batch.x_cont[..., 3]), phi], -1
                    ).astype(np.float32)


def _eta_sorted(seed):
    events = synthetic_events(3, seed=seed, n_min=120, n_max=250)
    batch, _ = sort_by_eta(collate(events, buckets=(256,)))
    return _etaphi(batch), np.array(batch.mask), required_halo(batch, 0.4)


def _clustered(seed):
    """Clusters at eta -2, 0, 2 on a 0.1 lattice (many pairs at exactly
    0.4 in decimal, a rounding question in f32), phi on the same lattice."""
    rng = np.random.default_rng(seed)
    B, N = 3, 256
    eta = np.sort(rng.choice([-2.0, 0.0, 2.0], size=(B, N))
                  + np.round(rng.normal(0, 0.2, (B, N)), 1), axis=1)
    phi = np.round(rng.uniform(-1.0, 1.0, (B, N)), 1)
    mask = np.arange(N)[None, :] < np.array([[256], [200], [9]])
    eta = np.where(mask, eta, 0.0)
    pos = np.stack([eta, np.where(mask, phi, 0.0)], -1).astype(np.float32)
    span = max(int(np.sum(np.abs(e[m][:, None] - e[m][None, :]) < 0.41, 1).max())
               for e, m in zip(eta, mask))
    return pos, mask, span


def _cell_sorted(seed):
    events = synthetic_events(3, seed=seed, n_min=120, n_max=250)
    batch = cell_sort_batch(collate(events, buckets=(256,)), r=0.4)
    return _etaphi(batch), np.array(batch.mask), required_span_batch(batch, 0.4)


def _padded(seed):
    rng = np.random.default_rng(seed)
    B, N = 3, 128
    eta = np.sort(rng.uniform(-3, 3, (B, N)), axis=1)
    phi = rng.uniform(-np.pi, np.pi, (B, N))
    mask = np.arange(N)[None, :] < np.array([[100], [0], [57]])
    return np.stack([eta, phi], -1).astype(np.float32), mask, 40


CASES = {"eta_sorted": _eta_sorted, "clustered_ties": _clustered,
         "cell_sorted": _cell_sorted, "padded": _padded}


@pytest.mark.parametrize("case", list(CASES))
def test_window_max_equals_jax_exactly(case):
    pos, mask, halo = CASES[case](seed=3)
    rng = np.random.default_rng(7)
    c = rng.normal(size=pos.shape[:2] + (8,)).astype(np.float32)
    if case == "clustered_ties":
        c = np.round(c, 1)                         # exact value ties

    got = window_max_torch(torch.as_tensor(c), torch.as_tensor(pos),
                           torch.as_tensor(mask), R2, halo).numpy()
    xla = np.asarray(window_max_xla(jnp.asarray(c), jnp.asarray(pos),
                                    jnp.asarray(mask), R2, halo))
    np.testing.assert_array_equal(got[mask], xla[mask])
    assert np.all(got[~mask] == -np.inf)

    pos_pad = np.where(mask[..., None], pos, jpal.PAD_POS).astype(np.float32)
    pallas = np.asarray(jpal.window_max(jnp.asarray(c), jnp.asarray(pos_pad),
                                        R2, halo, 128, True))
    np.testing.assert_array_equal(got[mask], pallas[mask])

    # the kernel's wrapper on a CPU tensor: the plain version with padded
    # rows placed at PAD_POS, equal on real rows and −inf on padded ones
    wrapped = tcu.window_max(torch.as_tensor(c), torch.as_tensor(pos_pad),
                             R2, halo).numpy()
    np.testing.assert_array_equal(wrapped[mask], got[mask])
    assert np.all(wrapped[~mask] == -np.inf)


@pytest.mark.parametrize("case", list(CASES))
def test_window_edgeconv_linear_matches_jax(case):
    pos, mask, halo = CASES[case](seed=5)
    rng = np.random.default_rng(11)
    H = 8
    x = rng.normal(size=pos.shape[:2] + (H,)).astype(np.float32)
    w = rng.normal(size=(2 * H, H)).astype(np.float32)
    b = rng.normal(size=(H,)).astype(np.float32)
    want = np.asarray(j_wecl(jnp.asarray(x),
                             JWindowGraph(jnp.asarray(pos), jnp.asarray(mask),
                                          r=0.4, halo=halo),
                             jnp.asarray(w), jnp.asarray(b)))
    g = WindowGraph(torch.as_tensor(pos), torch.as_tensor(mask), r=0.4,
                    halo=halo)
    args = (torch.as_tensor(x), g, torch.as_tensor(w), torch.as_tensor(b))
    got = window_edgeconv_linear(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[~mask] == 0.0)
    # the CUDA wrapper's CPU path and the dispatcher give the same bits
    np.testing.assert_array_equal(tcu.window_edgeconv_linear_cuda(*args).numpy(),
                                  got)
    np.testing.assert_array_equal(edgeconv(*args).numpy(), got)


@pytest.mark.parametrize("case", list(CASES))
def test_window_max_bwd_matches_pallas_vjp(case):
    pos, mask, halo = CASES[case](seed=3)
    rng = np.random.default_rng(9)
    c = rng.normal(size=pos.shape[:2] + (8,)).astype(np.float32)
    if case == "clustered_ties":
        c = np.round(c, 1)                         # exact value ties
    g = rng.normal(size=c.shape).astype(np.float32)
    pos_pad = np.where(mask[..., None], pos, jpal.PAD_POS).astype(np.float32)

    _, vjp = jax.vjp(lambda cc: jpal.window_max(cc, jnp.asarray(pos_pad), R2,
                                                halo, 128, True),
                     jnp.asarray(c))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    ct, pt = torch.as_tensor(c), torch.as_tensor(pos_pad)
    m = tcu.window_max(ct, pt, R2, halo)
    got = window_max_bwd_torch(ct, pt, m, torch.as_tensor(g), R2, halo)
    # padded rows: the Pallas window reaches past ±halo, and padded rows
    # all sit at one coordinate, so only real rows are comparable
    np.testing.assert_allclose(got.numpy()[mask], want[mask], rtol=1e-6,
                               atol=1e-6)
    if case == "clustered_ties":   # ties took the full gradient, not a share
        tied = (c[..., None, :] == c[..., None, :, :]).sum(-2) > 1
        assert (tied & mask[..., None]).any()
    # the autograd function's backward on a CPU tensor is the same function
    cg = ct.clone().requires_grad_(True)
    tcu.WindowMax.apply(cg, pt, R2, halo).backward(torch.as_tensor(g))
    assert torch.equal(cg.grad, got)


@pytest.mark.parametrize("case", list(CASES))
def test_window_edgeconv_linear_grads_match_pallas(case):
    pos, mask, halo = CASES[case](seed=5)
    rng = np.random.default_rng(13)
    H = 8
    x = rng.normal(size=pos.shape[:2] + (H,)).astype(np.float32)
    w = rng.normal(size=(2 * H, H)).astype(np.float32)
    b = rng.normal(size=(H,)).astype(np.float32)
    G = rng.normal(size=pos.shape[:2] + (H,)).astype(np.float32)
    jg = JWindowGraph(jnp.asarray(pos), jnp.asarray(mask), r=0.4, halo=halo)

    def jloss(xx, ww, bb):
        out = jpal.window_edgeconv_linear_pallas(xx, jg, ww, bb, tile=128,
                                                 interpret=True)
        return jnp.sum(out * jnp.asarray(G))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(b))
    g = WindowGraph(torch.as_tensor(pos), torch.as_tensor(mask), r=0.4,
                    halo=halo)
    for fn in (window_edgeconv_linear, edgeconv):   # plain autograd, kernel path
        args = [torch.as_tensor(a).requires_grad_(True) for a in (x, w, b)]
        (fn(args[0], g, args[1], args[2]) * torch.as_tensor(G)).sum().backward()
        for a, ref in zip(args, want):
            ref = np.asarray(ref)
            np.testing.assert_allclose(a.grad.numpy(), ref, rtol=1e-5,
                                       atol=2e-6 * np.abs(ref).max())
        assert np.all(args[0].grad.numpy()[~mask] == 0.0)


def test_unported_paths_raise():
    x = torch.zeros(1, 4, 8)
    w = torch.zeros(16, 8)
    g = WindowGraph(torch.zeros(1, 4, 2), torch.ones(1, 4, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        edgeconv(x, object(), w, None)
    with pytest.raises(ValueError, match="unknown reduction"):
        edgeconv(x, g, w, None, "median")
    with pytest.raises(ValueError, match="unsupported device"):
        tcu.window_max(torch.zeros(1, 4, 8, device="meta"),
                       torch.zeros(1, 4, 2, device="meta"), R2, 2)
    meta = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcu.window_max_bwd(meta, torch.zeros(1, 4, 2, device="meta"), meta,
                           meta, R2, 2)


def test_kernel_padding_threshold_is_padded_rows():
    # csrc/window_max.cu marks a row padded by its own constant PAD_HALF;
    # it must be ops/window.py's PAD_POS / 2, the threshold of padded_rows
    import re
    from deepmetv2_tpu_torch.ops.cuda.build import CSRC

    src = (CSRC / "window_max.cu").read_text()
    half = re.findall(r"constexpr float PAD_HALF = ([0-9.eE+-]+)f;", src)
    assert len(half) == 1
    assert np.float32(half[0]) == np.float32(PAD_POS / 2)
    assert "return eta >= PAD_HALF;" in src
    edge = np.float32(PAD_POS / 2)
    below = np.nextafter(edge, np.float32(0))
    pos = torch.tensor([[[edge, 0.0], [below, 0.0]]])
    assert padded_rows(pos).tolist() == [[True, False]]


def test_wrappers_align_pos():
    # the kernels read pos rows as float2: a view at an odd float offset
    # reaches them as an aligned copy, an aligned pos as itself
    odd = torch.arange(9, dtype=torch.float32)[1:].view(1, 4, 2)
    assert odd.data_ptr() % 8 == 4
    got = tcu._pos(odd)
    assert got.data_ptr() % 8 == 0 and torch.equal(got, odd)
    pos = torch.zeros(1, 4, 2)
    assert tcu._pos(pos).data_ptr() == pos.data_ptr()


def _inputs(case, seed=3):
    """(c, pos with padded rows at PAD_POS, mask, halo) of a case; values
    rounded to 0.1 in the clustered case (exact ties)."""
    pos, mask, halo = CASES[case](seed=seed)
    c = np.random.default_rng(7).normal(size=pos.shape[:2] + (8,))
    if case == "clustered_ties":
        c = np.round(c, 1)
    pos_pad = np.where(mask[..., None], pos, PAD_POS).astype(np.float32)
    return c.astype(np.float32), pos_pad, mask, halo


@pytest.mark.parametrize("case", list(CASES))
def test_wrappers_define_padded_rows(case):
    c, pos, mask, halo = _inputs(case)
    ct, pt = torch.as_tensor(c), torch.as_tensor(pos)
    assert torch.equal(padded_rows(pt), torch.as_tensor(~mask))
    m = tcu.window_max(ct, pt, R2, halo)
    assert torch.all(m[~mask] == float("-inf"))
    pallas = np.asarray(jpal.window_max(jnp.asarray(c), jnp.asarray(pos), R2,
                                        halo, 128, True))
    xla = np.asarray(window_max_xla(jnp.asarray(c), jnp.asarray(pos),
                                    jnp.asarray(mask), R2, halo))
    np.testing.assert_array_equal(m.numpy()[mask], pallas[mask])
    np.testing.assert_array_equal(m.numpy()[mask], xla[mask])
    assert torch.equal(tcu.window_max_pipelined(ct, pt, R2, halo), m)

    g = np.random.default_rng(9).normal(size=c.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda cc: jpal.window_max(cc, jnp.asarray(pos), R2,
                                                halo, 128, True),
                     jnp.asarray(c))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    dc = tcu.window_max_bwd(ct, pt, m, torch.as_tensor(g), R2, halo)
    assert torch.all(dc[~torch.as_tensor(mask)] == 0)
    np.testing.assert_allclose(dc.numpy()[mask], want[mask], rtol=1e-6,
                               atol=1e-6)
    cg = ct.clone().requires_grad_(True)
    tcu.WindowMax.apply(cg, pt, R2, halo).backward(torch.as_tensor(g))
    assert torch.equal(cg.grad, dc)
    # whatever m holds at padded rows: the padded sources stay 0 (a padded
    # row's own value as its "max" would tie it) and the padded queries
    # give real sources nothing
    junk = torch.where(torch.as_tensor(mask)[..., None], m, ct)
    assert torch.equal(tcu.window_max_bwd(ct, pt, junk, torch.as_tensor(g),
                                          R2, halo), dc)


def _chunk_of(rows, chunk, halo, q, s):
    """(block of row q, chunk of row s in that block's window)."""
    t = q // rows
    return t, (s - np.maximum(0, t * rows - halo)) // chunk


@pytest.mark.parametrize("rows,chunk", [(32, 32), (8, 16)])
@pytest.mark.parametrize("case", list(CASES))
def test_chunk_prune_keeps_every_adjacent_pair(case, rows, chunk):
    _, pos, mask, halo = _inputs(case)
    pt = torch.as_tensor(pos)
    needed = window_chunks_needed(pt, rows, chunk, halo, R2).numpy()
    B, N, _ = pos.shape
    real = torch.as_tensor(mask)
    adj = (adjacent(pt[:, :, None, 0], pt[:, :, None, 1], pt[:, None, :, 0],
                    pt[:, None, :, 1], R2)
           & real[:, :, None] & real[:, None, :]).numpy()
    i = np.arange(N)
    adj &= np.abs(i[:, None] - i[None, :]) <= halo
    b, q, s = np.nonzero(adj)
    assert len(b) > 0
    t, k = _chunk_of(rows, chunk, halo, q, s)
    assert needed[b, t, k].all()
    # a block without a real row needs nothing
    nb = needed.shape[1]
    blk_real = np.pad(mask, ((0, 0), (0, nb * rows - N))).reshape(
        B, nb, rows).any(-1)
    assert not needed[~blk_real].any()
    if case == "cell_sorted":      # the phi test prunes inside the window
        assert needed[blk_real].mean() < 0.95


@settings(max_examples=60, deadline=None, database=None)
@given(a=st.floats(-3.0, 3.0, width=32), ulps=st.sampled_from([-1, 0, 1]),
       axis=st.sampled_from([0, 1]), r=st.sampled_from([0.4, 0.3, 0.8]),
       spread=st.floats(0.0, 0.25, width=32))
def test_chunk_prune_is_exact_at_the_radius(a, ulps, axis, r, spread):
    # block 0 (rows 0..31) spans [a - spread, a] on one axis, chunk 1 (rows
    # 32..63) [b, b + spread] with b = a + r moved by `ulps` ulps, the other
    # axis constant: the only candidate pair is (a, b), and the chunk is
    # needed exactly when that pair is adjacent
    a = np.float32(a)
    b = np.float32(a + np.float32(r))
    for _ in range(abs(ulps)):
        b = np.nextafter(b, np.float32(np.inf * ulps))
    near = a - np.linspace(0, spread, 32, dtype=np.float32)[::-1]
    far = b + np.linspace(0, spread, 32, dtype=np.float32)
    pos = np.full((1, 64, 2), 0.5, np.float32)
    pos[0, :, axis] = np.concatenate([near, far])
    pt = torch.as_tensor(pos)
    r2 = r * r
    needed = window_chunks_needed(pt, 32, 32, 32, r2)
    pair = bool(adjacent(pt[0, 31, 0], pt[0, 31, 1], pt[0, 32, 0],
                         pt[0, 32, 1], r2))
    assert bool(needed[0, 0, 1]) == pair
    assert bool(needed[0, 1, 0]) == pair       # the symmetric block
    assert bool(needed[0, 0, 0]) and bool(needed[0, 1, 1])
    got = window_max_torch(torch.ones(1, 64, 1), pt, torch.ones(1, 64,
                                                                 dtype=bool),
                           r2, 32)
    assert torch.isfinite(got).all()


def _pruned_window_max(c, pos, r2, halo, rows, chunk):
    """The forward kernel's loop in plain torch: per block of ``rows``
    query rows, only the chunks ``window_chunks_needed`` keeps."""
    B, N, H = c.shape
    needed = window_chunks_needed(pos, rows, chunk, halo, r2)
    real = ~padded_rows(pos)
    neg = torch.tensor(float("-inf"))
    m = torch.full_like(c, float("-inf"))
    for t in range(needed.shape[1]):
        t0, lo = t * rows, max(0, t * rows - halo)
        hi = min(N, t0 + rows + halo)
        q = torch.arange(t0, min(N, t0 + rows))
        for k in range(needed.shape[2]):
            if lo + k * chunk >= hi:
                break
            s = torch.arange(lo + k * chunk, min(hi, lo + (k + 1) * chunk))
            adj = (adjacent(pos[:, q, None, 0], pos[:, q, None, 1],
                            pos[:, None, s, 0], pos[:, None, s, 1], r2)
                   & ((s[None, :] - q[:, None]).abs() <= halo)
                   & real[:, q, None] & real[:, None, s]
                   & needed[:, t, k, None, None])
            cand = torch.where(adj[..., None], c[:, None, s], neg).amax(2)
            m[:, q] = torch.maximum(m[:, q], cand)
    return m


def _pruned_window_max_bwd(c, pos, m, g, r2, halo, rows, chunk):
    """The backward kernel's loop in plain torch: per block of ``rows``
    source rows, the needed query chunks in order, each source adding its
    terms in ascending query order from 0."""
    B, N, H = c.shape
    needed = window_chunks_needed(pos, rows, chunk, halo, r2)
    real = ~padded_rows(pos)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.full_like(m, float("inf")))
    g_safe = torch.where(finite, g, torch.zeros_like(g))
    dc = torch.zeros_like(c)
    for t in range(needed.shape[1]):
        t0, lo = t * rows, max(0, t * rows - halo)
        hi = min(N, t0 + rows + halo)
        s = torch.arange(t0, min(N, t0 + rows))
        for k in range(needed.shape[2]):
            for q in range(lo + k * chunk, min(hi, lo + (k + 1) * chunk)):
                adj = (adjacent(pos[:, q, None, 0], pos[:, q, None, 1],
                                pos[:, s, 0], pos[:, s, 1], r2)
                       & ((s - q).abs() <= halo) & real[:, q, None]
                       & real[:, s] & needed[:, t, k, None])
                hit = adj[..., None] & (c[:, s] == m_safe[:, q, None])
                dc[:, s] += torch.where(hit, g_safe[:, q, None], 0.0)
    return dc


@pytest.mark.parametrize("rows,chunk", [(32, 32), (8, 16)])
@pytest.mark.parametrize("case", list(CASES))
def test_pruned_loop_equals_plain_versions(case, rows, chunk):
    c, pos, mask, halo = _inputs(case)
    ct, pt = torch.as_tensor(c), torch.as_tensor(pos)
    want = window_max_torch(ct, pt, ~padded_rows(pt), R2, halo)
    got = _pruned_window_max(ct, pt, R2, halo, rows, chunk)
    assert torch.equal(got, want)
    g = torch.as_tensor(np.random.default_rng(9).normal(size=c.shape)
                        .astype(np.float32))
    want_dc = window_max_bwd_torch(ct, pt, want, g, R2, halo)
    got_dc = _pruned_window_max_bwd(ct, pt, want, g, R2, halo, rows, chunk)
    assert torch.equal(got_dc, want_dc)
