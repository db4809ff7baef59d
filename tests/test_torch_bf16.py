"""bf16 compute on the window-mode GraphMET path (``ModelConfig.
compute_dtype='bfloat16'``), and the window 'sum' / 'mean' reductions,
against the JAX package on the CPU.

The JAX package's CPU path ignores ``compute_dtype``: on a CPU
``deepmetv2_tpu/ops/edgeconv.py`` takes its XLA twin and drops the dtype.
The port follows its accelerator path, the Pallas kernel with
``dtype=bfloat16``.  Here JAX is put on that path with pytest's
``monkeypatch`` (``jax_pallas_path``): ``deepmetv2_tpu.ops.edgeconv.
_on_tpu`` returns True and ``window_edgeconv_linear_pallas`` runs in
interpret mode (with a 128-row tile at small N); no file of the JAX
package changes.

Tolerances, each with its reason:
- the window max twin on bf16 values equals JAX's Pallas kernel bitwise
  on real rows, up to the sign of a zero (a max selects one input; torch's
  maximum and XLA's pick either zero of a ±0 tie: the card's check
  forgives the same);
- its backward's ``dc`` is within one bf16 ulp: both sum the terms in
  float32 and round once, JAX in its chunks' order, the port in ascending
  query order;
- the bf16 EdgeConv's output against JAX's is within one bf16 rounding of
  c (2**-8 of |c| plus 1e-6 of the largest output): the float32 GEMMs sum
  in other orders, so a c next to a rounding boundary can land one ulp
  apart; its gradients within 2 % of the largest entry, for the same
  reason (a flipped rounding moves a selection or a bf16 cotangent).
  The port's bf16-against-f32 error has to match JAX's within 1.5x in
  the median, which a missing bf16 rounding of a gradient would break;
- the model's forward and one AdamW step as in ``tests/test_torch_train``
  widened to those roundings.

``jax_bf16_eval_loss()`` recomputes ``chip_smoke.GOLDEN_BF16_LOSS`` and
``jax_bf16_resume_losses(10)`` ``chip_smoke.GOLDEN_BF16_TRAIN_LOSSES``;
``port_bf16_eval_loss()`` and ``port_bf16_resume_losses(10)`` are the
port's CPU runs of the same, the source of the smoke's gates.
"""

import contextlib
import dataclasses
import functools
import io
import itertools
import os.path as osp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepmetv2_tpu.config import Config as JConfig
from deepmetv2_tpu.config import DataConfig as JDataConfig
from deepmetv2_tpu.config import GraphConfig as JGraphConfig
from deepmetv2_tpu.config import ModelConfig as JModelConfig
from deepmetv2_tpu.data import collate
from deepmetv2_tpu.data import loader as jl
from deepmetv2_tpu.data.sorting import cell_sort_batch, required_span_batch
from deepmetv2_tpu.models.graph_met import graph_met_apply as j_apply
from deepmetv2_tpu.models.graph_met import graph_met_init as j_init
from deepmetv2_tpu.ops.pallas import edgeconv_window as jpal
from deepmetv2_tpu.ops.window import WindowGraph as JWindowGraph
from deepmetv2_tpu.ops.window import window_edgeconv_linear as j_wecl
from deepmetv2_tpu.train import checkpoint as jck
from deepmetv2_tpu.train.step import build_graph as j_build
from deepmetv2_tpu.train.step import init_train_state, make_train_step
from deepmetv2_tpu_torch.config import Config, DataConfig, GraphConfig
from deepmetv2_tpu_torch.config import ModelConfig
from deepmetv2_tpu_torch.data import loader as tl
from deepmetv2_tpu_torch.data.batching import to_device
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.ops.cuda import edgeconv_window as tcu
from deepmetv2_tpu_torch.ops.edgeconv import edgeconv
from deepmetv2_tpu_torch.ops.window import (PAD_POS, WindowGraph,
                                            window_edgeconv_linear,
                                            window_max_bwd_torch,
                                            window_max_torch)
from deepmetv2_tpu_torch.train import step as tstep
from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
from tests.torch_threads import few_torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
BF16_CKPTS = osp.join(REPO, "ckpts_syn_bf16")
R2 = 0.4 ** 2
BF16_EPS = 2.0 ** -8          # one bf16 ulp relative to a value's magnitude


@contextlib.contextmanager
def jax_pallas_path(tile=None):
    """The JAX package's accelerator path on the CPU: ``edgeconv`` takes
    ``window_edgeconv_linear_pallas`` (interpret mode; ``tile`` rows per
    grid step, the kernel's default if None) with the model's dtype."""
    import deepmetv2_tpu.ops.edgeconv as j_edgeconv

    kw = {"interpret": True} if tile is None else {"interpret": True,
                                                    "tile": tile}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_edgeconv, "_on_tpu", lambda: True)
        mp.setattr(jpal, "window_edgeconv_linear_pallas",
                   functools.partial(jpal.window_edgeconv_linear_pallas, **kw))
        yield


def _ckpt_copy(dst=None):
    """A copy of ckpts_syn_bf16's config.json and best.ckpt in ``dst`` (a
    new temporary directory if None): evaluate writes best.resolutions
    beside them."""
    import os
    import tempfile

    dst = dst or tempfile.mkdtemp(prefix="bf16_ckpts")
    os.makedirs(dst, exist_ok=True)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(osp.join(BF16_CKPTS, f), dst)
    return dst


def jax_bf16_eval_loss(events: int = 2000, batch_size: int = 40,
                       work=None):
    """The JAX package's ``cli.evaluate --synthetic <events>`` on a copy of
    ckpts_syn_bf16 on its Pallas path (interpret mode, bf16): the source of
    ``chip_smoke.GOLDEN_BF16_LOSS`` (2000 events: its 400 validation
    events at batch 40)."""
    from deepmetv2_tpu.cli import evaluate as j_eval

    ck = _ckpt_copy(work)
    out = io.StringIO()
    with jax_pallas_path(), contextlib.redirect_stdout(out):
        assert j_eval.main(["--synthetic", str(events), "--ckpts", ck,
                            "--restore_file", "best", "--batch_size",
                            str(batch_size)]) == 0
    return float(out.getvalue().split("validation loss:")[1].split()[0])


def port_bf16_eval_loss(events: int = 2000, batch_size: int = 40,
                        work=None):
    """The port's ``cli.evaluate`` of ``jax_bf16_eval_loss`` on the CPU."""
    from deepmetv2_tpu_torch.cli import evaluate as t_eval

    ck = _ckpt_copy(work)
    return t_eval.run(["--synthetic", str(events), "--ckpts", ck,
                       "--restore_file", "best", "--batch_size",
                       str(batch_size), "--device", "cpu"])["loss"]


def _resume_batches(n_steps, loader_mod):
    """The first ``n_steps`` cell-sorted train batches of synthetic 2000
    (seed 42, batch 8), as the train CLI presorts them."""
    ld = loader_mod.fetch_dataloader(
        events=synthetic_events(2000, seed=42), batch_size=8,
        presort_eta=True, presort_mode="cell")["train"]
    return list(itertools.islice(iter(ld), n_steps))


def _bf16_configs(halo, batch_size):
    g = dict(mode="window", window_halo=halo, presorted=True)
    j = JConfig(graph=JGraphConfig(**g), data=JDataConfig(batch_size=batch_size),
                model=JModelConfig(compute_dtype="bfloat16"))
    t = Config(graph=GraphConfig(**g), data=DataConfig(batch_size=batch_size),
               model=ModelConfig(compute_dtype="bfloat16"))
    return j, t


def jax_bf16_resume_losses(n_steps: int):
    """The JAX package's train losses from ckpts_syn_bf16/best.ckpt on its
    Pallas path (interpret mode, bf16) over ``_resume_batches`` (halo
    192): the source of ``chip_smoke.GOLDEN_BF16_TRAIN_LOSSES``."""
    jcfg, _ = _bf16_configs(192, 8)
    template = init_train_state(*j_init(jax.random.PRNGKey(0)), jcfg)
    state, _ = jck.load_checkpoint(osp.join(BF16_CKPTS, "best.ckpt"),
                                   template=template)
    losses = []
    with jax_pallas_path():
        step = make_train_step(jcfg)
        for b in _resume_batches(n_steps, jl):
            state, loss = step(state, b)
            losses.append(float(loss))
    return losses


def port_bf16_resume_losses(n_steps: int):
    """The port's steps of ``jax_bf16_resume_losses`` on the CPU."""
    _, tcfg = _bf16_configs(192, 8)
    model = GraphMET(tcfg.model)
    opt = tstep.make_optimizer(tcfg, model)
    restore_checkpoint(osp.join(BF16_CKPTS, "best.ckpt"), model, opt)
    step = tstep.make_train_step(tcfg)
    return [float(step(model, opt, to_device(b, "cpu")))
            for b in _resume_batches(n_steps, tl)]


# ---------------------------------------------------------------- inputs


def _cell_sorted(seed, n_events=3, N=256):
    """Cell-sorted synthetic events padded to N: (batch, pos [B, N, 2] f32
    with padded rows at PAD_POS, mask, halo covering the order's span)."""
    events = synthetic_events(n_events, seed=seed, n_min=60, n_max=N - 6)
    batch = cell_sort_batch(collate(events, buckets=(N,)), r=0.4)
    xc = np.asarray(batch.x_cont)
    etaphi = np.stack([xc[..., 3], np.arctan2(xc[..., 1], xc[..., 0])],
                      -1).astype(np.float32)
    mask = np.array(batch.mask)
    pos = np.where(mask[..., None], etaphi, PAD_POS).astype(np.float32)
    return batch, etaphi, pos, mask, required_span_batch(batch, 0.4)


def _lattice(rng, shape):
    """bf16-exact values on a coarse lattice with many ties, ±0.0 among
    them, as float32."""
    v = rng.choice(np.arange(-8, 9) / 4.0, size=shape).astype(np.float32)
    zero = v == 0
    v[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    return v


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16)


def _jbf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _f32(t):
    """A torch or JAX array as a float32 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _bits(a):
    """float32 bits with the sign of a zero dropped."""
    return (np.asarray(a, np.float32) + np.float32(0.0)).view(np.int32)


def _ulps_bf16(a, b):
    """Elementwise distance in bf16 ulps of two arrays of bf16 values."""
    def key(x):
        i = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.int32) >> 16
        return np.where(i < 0, -(i & 0x7FFF), i).astype(np.int64)
    return np.abs(key(a) - key(b))


def _split_window_max(c, pos, halo):
    """JAX's Pallas ``window_max`` (interpret mode) on bf16 ``c``, with
    its VJP.  Its wrapper takes H dividing 128 or a multiple of it (at
    H=33 its lane unpacking fails), so other widths run as a call on the
    first 32 features and one on the rest: every feature is independent in
    both directions, so the split computes the same function."""
    H = c.shape[-1]
    parts = [(0, H)] if 128 % H == 0 else [(0, 32), (32, H)]
    pos = jnp.asarray(pos)

    def fn(cc):
        return jnp.concatenate(
            [jpal.window_max(cc[..., a:b], pos, R2, halo, 128, True)
             for a, b in parts], axis=-1)
    return jax.vjp(fn, _jbf16(c))


@pytest.mark.parametrize("H", [8, 32, 33])
def test_bf16_window_max_twins_match_pallas(H):
    """The plain versions on bf16 values against JAX's Pallas kernel in
    interpret mode on the same bf16 c: many ties, ±0.0, padded rows and an
    empty event.  The forward bitwise on real rows (up to the sign of a
    zero); the backward's dc within one bf16 ulp, its share of differing
    elements reported."""
    batch, etaphi, pos, mask, halo = _cell_sorted(3)
    mask[2] = False                                   # an empty event
    pos[2] = PAD_POS
    rng = np.random.default_rng(H)
    c = _lattice(rng, pos.shape[:2] + (H,))
    g = _lattice(rng, c.shape) * np.float32(0.375)
    ct, gt, post = _bf16(c), _bf16(g), torch.as_tensor(pos)

    m = window_max_torch(ct, post, torch.as_tensor(mask), R2, halo)
    mj, vjp = _split_window_max(c, pos, halo)
    assert m.dtype == torch.bfloat16 and mj.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(_f32(m)[mask]), _bits(_f32(mj)[mask]))
    assert np.all(_f32(m)[~mask] == -np.inf)
    assert tcu.window_max(ct, post, R2, halo).equal(m)      # the CPU path

    dc = window_max_bwd_torch(ct, post, m, gt, R2, halo)
    dcj = vjp(_jbf16(g))[0]
    assert dc.dtype == torch.bfloat16
    ulps = _ulps_bf16(_f32(dc)[mask], _f32(dcj)[mask])
    print(f"H={H}: dc differs from JAX's in {np.mean(ulps > 0):.2%} of the "
          f"real rows' elements, at most {ulps.max()} ulp")
    assert ulps.max() <= 1
    assert np.all(_f32(dc)[~mask] == 0.0)
    # ties: with g = 1 every tied source takes its query's full gradient
    ones = window_max_bwd_torch(ct, post, m, torch.ones_like(m), R2, halo)
    assert float(ones.float().sum()) > int(torch.isfinite(m.float()).sum())
    assert tcu.window_max_bwd(ct, post, m, gt, R2, halo).equal(dc)


def test_bf16_window_max_bwd_sums_in_float32():
    """The backward adds its terms in float32 and rounds once: 256 terms of
    1 + 2**-8 on one source sum to what float32 gives, where a bf16
    accumulator would stall at 256."""
    N, H = 300, 2
    pos = np.zeros((1, N, 2), np.float32)       # every pair adjacent
    c = np.zeros((1, N, H), np.float32)
    c[0, 0] = 1.0                               # source 0 is every max
    g = np.full((1, N, H), 1.0 + 2.0 ** -7, np.float32)
    ct, post = _bf16(c), torch.as_tensor(pos)
    m = window_max_torch(ct, post, torch.ones(1, N, dtype=torch.bool), R2,
                         N)
    dc = window_max_bwd_torch(ct, post, m, _bf16(g), R2, N)
    want = torch.tensor(N * (1.0 + 2.0 ** -7)).to(torch.bfloat16)
    assert torch.equal(dc[0, 0], want.expand(H))
    assert float(dc[0, 1:].float().abs().max()) == 0.0


def test_kernel_wrappers_check_value_types():
    c = torch.zeros(1, 4, 8, dtype=torch.bfloat16)
    pos = torch.zeros(1, 4, 2)
    with pytest.raises(TypeError, match="one type"):
        tcu._check("window_max_bwd", c, pos, c.float(), c)
    with pytest.raises(TypeError, match="one type"):
        tcu._check("window_max", c.half(), pos)
    with pytest.raises(TypeError, match="one type"):
        tcu._check("window_max", c, pos.to(torch.bfloat16))
    tcu._check("window_max_bwd", c, pos, c, c)
    tcu._check("window_max_bwd", c.float(), pos, c.float(), c.float())
    meta = torch.zeros(1, 4, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcu.window_max(meta, torch.zeros(1, 4, 2, device="meta"), R2, 2)
    assert set(tcu._ARGTYPES) >= {"window_max_fwd_bf16",
                                  "window_max_bwd_bf16"}
    src = (tcu.build.CSRC / "window_max.cu").read_text()
    for entry in ("window_max_fwd_bf16", "window_max_bwd_bf16"):
        assert f'extern "C" int {entry}(' in src


def _edge_inputs(seed, H=16):
    batch, etaphi, pos, mask, halo = _cell_sorted(seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=pos.shape[:2] + (H,)).astype(np.float32)
    w = (rng.normal(size=(2 * H, H)) * 0.3).astype(np.float32)
    b = rng.normal(size=(H,)).astype(np.float32)
    G = rng.normal(size=pos.shape[:2] + (H,)).astype(np.float32)
    tg = WindowGraph(torch.as_tensor(etaphi), torch.as_tensor(mask), r=0.4,
                     halo=halo)
    jg = JWindowGraph(jnp.asarray(etaphi), jnp.asarray(mask), r=0.4,
                      halo=halo)
    return (x, w, b, G), tg, jg, mask


def _edgeconv_both(args, tg, jg, bf16: bool):
    """(port, JAX) lists [out, dx, dw, db] of the EdgeConv with cotangent
    G: the port's ``window_edgeconv_linear_cuda`` on the CPU and JAX's
    ``window_edgeconv_linear_pallas`` in interpret mode."""
    x, w, b, G = args
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    out = tcu.window_edgeconv_linear_cuda(
        *ts[:1], tg, *ts[1:], torch.bfloat16 if bf16 else None)
    (out * torch.as_tensor(G)).sum().backward()
    port = [out.detach().numpy()] + [t.grad.numpy() for t in ts]

    def fn(xx, ww, bb):
        return jpal.window_edgeconv_linear_pallas(
            xx, jg, ww, bb, tile=128, interpret=True,
            dtype=jnp.bfloat16 if bf16 else None)
    jo, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, w, b)))
    return port, [np.asarray(jo)] + [np.asarray(v)
                                     for v in vjp(jnp.asarray(G))]


@pytest.mark.parametrize("seed", [3, 4])
def test_bf16_edgeconv_matches_pallas(seed):
    """The port's bf16 EdgeConv against ``window_edgeconv_linear_pallas(
    dtype=bfloat16)`` in interpret mode: the output and the gradients of x
    and W within one bf16 rounding, in under 1 % of the elements at all.
    One rounding is one ulp of the element (2**-7 of it) or, where two
    bf16 terms of a gradient cancel (dx sums its two GEMMs' terms, dW_diff
    is the difference of two), one ulp of a term, bounded by 2**-8 of the
    row's largest entry; plus float32 noise, 1e-5 of the largest entry.
    b's gradient takes no bf16 rounding: float32 noise.  Then each package's bf16-against-float32 error: their medians
    within 1.5x, for the output and the gradients of x and W (a gradient
    not rounded to bf16 per GEMM, or the two of x summed in float32, pulls
    the port's towards float32)."""
    args, tg, jg, mask = _edge_inputs(seed)
    port, jax_ = _edgeconv_both(args, tg, jg, bf16=True)
    for name, t, j in zip(("out", "dx", "dw"), port, jax_):
        d = np.abs(t - j)
        tol = (2.0 ** -7 * np.maximum(np.abs(t), np.abs(j))
               + 2.0 ** -8 * np.abs(j).max(-1, keepdims=True)
               + 1e-5 * np.abs(j).max())
        assert np.all(d <= tol), (name, float(d.max()))
        assert np.mean(d > 0) < 0.01, (name, float(np.mean(d > 0)))
    np.testing.assert_allclose(port[3], jax_[3], rtol=1e-5,
                               atol=1e-6 * np.abs(jax_[3]).max())
    assert np.all(port[0][~mask] == 0.0) and np.all(port[1][~mask] == 0.0)

    port32, jax32 = _edgeconv_both(args, tg, jg, bf16=False)
    for name, t, j, t32, j32 in zip(("out", "dx", "dw"), port, jax_, port32,
                                    jax32):
        et, ej = np.median(np.abs(t - t32)), np.median(np.abs(j - j32))
        assert ej > 0 and 1 / 1.5 <= et / ej <= 1.5, (name, et, ej)


# ---------------------------------------------------------------- the model

H_SMALL = 16


@pytest.fixture(scope="module")
def small():
    """Two cell-sorted batches of 4 events in the 256 bucket, their halo,
    and ckpts_syn_bf16's model at H=16 (depth 2, bf16), in both
    packages' configs."""
    events = synthetic_events(24, seed=5, n_min=60, n_max=250)
    ld = tl.fetch_dataloader(events=events, batch_size=4, buckets=(256,),
                             presort_eta=True,
                             presort_mode="cell")["train"]
    halo = max(64, -(-ld.required_halo(0.4) // 64) * 64)
    jcfg, tcfg = _bf16_configs(halo, 4)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, hidden_dim=H_SMALL))
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, hidden_dim=H_SMALL))
    return list(itertools.islice(iter(ld), 2)), jcfg, tcfg


def _forward_both(params, bn_state, batch, jcfg, tcfg, train):
    with jax_pallas_path(tile=128):
        jb, jg = j_build(batch, jcfg)
        js, jstate = j_apply(params, bn_state, jb, jg, train=train,
                             cfg=jcfg.model)
    model = GraphMET(tcfg.model).params_from_jax(params, bn_state)
    model.train(train)
    tb, tg = tstep.build_graph(to_device(batch, "cpu"), tcfg)
    with torch.no_grad():
        ts = model(tb, tg)
    mask = np.asarray(batch.mask)
    return np.asarray(js)[mask], jstate, ts.numpy()[mask], model


@pytest.mark.parametrize("train", [False, True])
def test_bf16_graph_met_matches_jax_pallas_path(small, train):
    """GraphMET's scores in bf16 against ``graph_met_apply`` on JAX's
    Pallas path, eval and train mode (batch statistics and the running
    buffers), at real nodes: within 2e-3 of the largest score, a bf16
    rounding of c carried through a BatchNorm and the head; the port's
    parameters stay float32."""
    batches, jcfg, tcfg = small
    params, bn_state = j_init(jax.random.PRNGKey(3), jcfg.model)
    js, jstate, ts, model = _forward_both(params, bn_state, batches[0],
                                          jcfg, tcfg, train)
    scale = np.abs(js).max()
    np.testing.assert_allclose(ts, js, rtol=0, atol=2e-3 * scale)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if train:
        for d, conv in enumerate(model.convs):
            np.testing.assert_allclose(conv.bn.running_mean.numpy(),
                                       np.asarray(jstate["convs"][d].mean),
                                       rtol=0, atol=1e-4)


def test_bf16_train_step_matches_jax_pallas_path(small):
    """Two AdamW steps from a fresh JAX init, bf16 in both packages: the
    losses within 1e-4 relative and every parameter within 0.1·lr per step
    (lr 1e-3: AdamW normalises a gradient whose bf16 rounding flipped by
    an ulp into an update a fraction of lr away; 0.045·lr read); the
    EdgeConv biases, whose gradient is rounding noise behind a BatchNorm,
    and the running means that track them within 2·lr per step, as in
    tests/test_torch_train.py."""
    batches, jcfg, tcfg = small
    params, bn_state = j_init(jax.random.PRNGKey(4), jcfg.model)
    model = GraphMET(tcfg.model).params_from_jax(params, bn_state)
    opt = tstep.make_optimizer(tcfg, model)
    state = init_train_state(params, bn_state, jcfg)  # the step donates it
    jlosses = []
    with jax_pallas_path(tile=128):
        jstep = make_train_step(jcfg)
        for b in batches:
            state, loss = jstep(state, b)
            jlosses.append(float(loss))
    step = tstep.make_train_step(tcfg)
    tlosses = [float(step(model, opt, to_device(b, "cpu"))) for b in batches]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    want = GraphMET(tcfg.model).params_from_jax(state.params, state.bn_state)
    for (path, got), (_, ref) in zip(model.jax_layout(), want.jax_layout()):
        noise = path[1] == "convs" and path[3:] in (("edge", "b"), (0,))
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                   rtol=0, err_msg=str(path),
                                   atol=(2e-3 if noise else 1e-4)
                                   * len(batches))


def test_bf16_neighbor_list_is_float32(small):
    """In neighbor_list mode ``compute_dtype`` changes nothing, as in the
    JAX package (its ``edgeconv_linear`` takes no dtype): a bf16 GraphMET's
    scores and gradients equal the float32 one's bitwise."""
    batches, _, tcfg = small
    cfg = dataclasses.replace(tcfg, graph=GraphConfig())   # neighbor_list
    tb, tg = tstep.build_graph(to_device(batches[0], "cpu"), cfg)
    out = []
    for dtype in ("bfloat16", "float32"):
        torch.manual_seed(0)
        model = GraphMET(dataclasses.replace(cfg.model, compute_dtype=dtype),
                         generator=torch.Generator().manual_seed(7)).train()
        s = model(tb, tg)
        s.square().sum().backward()
        out.append([s.detach()] + [p.grad for p in model.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ------------------------------------------------- window 'sum' and 'mean'


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_window_sum_mean_match_jax(reduction):
    """``edgeconv`` over a WindowGraph with 'sum' and 'mean' against the
    JAX package's ``window_edgeconv_linear``: the forward and the
    gradients of x, W and b, on cell-sorted events with padded rows and an
    empty event, whose rows have no neighbour ('mean' gives 0 there, 'sum'
    deg·a + Σc = 0); float32 sums in other orders: rtol 1e-5, atol 2e-6 of
    the largest entry."""
    (x, w, b, G), tg, jg, mask = _edge_inputs(6, H=8)
    tg = WindowGraph(tg.etaphi, tg.mask.clone(), r=0.4, halo=tg.halo)
    tg.mask[1] = False
    jg = JWindowGraph(jg.etaphi, jnp.asarray(tg.mask.numpy()), r=0.4,
                      halo=jg.halo)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    out = edgeconv(ts[0], tg, ts[1], ts[2], reduction)
    (out * torch.as_tensor(G)).sum().backward()

    def fn(xx, ww, bb):
        return j_wecl(xx, jg, ww, bb, reduction)
    jo, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, w, b)))
    for got, want in zip([out.detach()] + [t.grad for t in ts],
                         [jo] + list(vjp(jnp.asarray(G)))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=2e-6 * np.abs(want).max())
    real = tg.mask.numpy()
    assert np.all(out.detach().numpy()[~real] == 0.0)
    assert np.all(ts[0].grad.numpy()[~real] == 0.0)
    assert torch.equal(out, window_edgeconv_linear(*ts[:1], tg, *ts[1:],
                                                   reduction))


def test_window_unknown_reduction_raises():
    x = torch.zeros(1, 4, 8)
    g = WindowGraph(torch.zeros(1, 4, 2), torch.ones(1, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="unknown reduction"):
        edgeconv(x, g, torch.zeros(16, 8), None, "median")


# ---------------------------------------------------------------- the CLIs


def test_evaluate_cli_bf16_checkpoint_matches_jax():
    """``cli.evaluate --device cpu`` on a copy of ckpts_syn_bf16 (40
    synthetic events: 8 validation events, one batch) against the JAX
    package's evaluate CLI on its Pallas path (interpret mode, bf16):
    within 1e-5 relative (over the 400 validation events of synthetic 2000
    the two read 1.2e-7 apart); ckpts_syn_bf16 itself is only read."""
    before = {f: osp.getmtime(osp.join(BF16_CKPTS, f))
              for f in ("best.ckpt", "best.resolutions")}
    want = jax_bf16_eval_loss(40, 8)
    got = port_bf16_eval_loss(40, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert before == {f: osp.getmtime(osp.join(BF16_CKPTS, f))
                      for f in before}


def test_train_cli_bf16_one_epoch(tmp_path):
    """``cli.train --compute_dtype bfloat16 --device cpu``: one short epoch
    with finite losses, the dtype recorded in config.json, and its
    best.ckpt evaluated by ``cli.evaluate`` in bf16 to the loss it
    recorded (within 1e-6)."""
    import json

    from deepmetv2_tpu_torch.cli import evaluate as t_eval
    from deepmetv2_tpu_torch.cli import train as train_cli

    ck = str(tmp_path / "ck")
    assert train_cli.main(["--synthetic", "20", "--batch_size", "4",
                           "--epochs", "1", "--ckpts", ck, "--device", "cpu",
                           "--compute_dtype", "bfloat16"]) == 0
    with open(osp.join(ck, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["model"]["compute_dtype"] == "bfloat16"
    assert cfg["graph"]["mode"] == "window"
    with open(osp.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    assert np.isfinite(best)
    got = t_eval.run(["--synthetic", "20", "--ckpts", ck, "--batch_size",
                      "4", "--device", "cpu"])["loss"]
    np.testing.assert_allclose(got, best, rtol=1e-6)


def test_golden_bf16_guard():
    """``chip_smoke``'s bf16 goldens and gates: the first two of
    GOLDEN_BF16_TRAIN_LOSSES recomputed by the JAX package (rtol 1e-6) and
    the port's CPU steps within the smoke's gate; the gates no wider than
    1e-3 relative."""
    golden = chip_smoke.GOLDEN_BF16_TRAIN_LOSSES
    assert len(golden) == 10
    assert chip_smoke.BF16_LOSS_RTOL <= 1e-3
    assert chip_smoke.BF16_TRAIN_RTOL <= 1e-3
    np.testing.assert_allclose(jax_bf16_resume_losses(2), golden[:2],
                               rtol=1e-6)
    np.testing.assert_allclose(port_bf16_resume_losses(2), golden[:2],
                               rtol=chip_smoke.BF16_TRAIN_RTOL)
