"""The port's DRN training path against the JAX package's, on the CPU.

The JAX side runs its fused graph build and fused edge-MLP conv as Pallas
kernels in interpret mode (``graph_force="fused", conv_force="fused"``),
the path the port computes (its own CPU CLI takes the composed XLA path,
ROADMAP C).

``jax_drn_resume_losses(10)`` recomputes ``chip_smoke.GOLDEN_DRN_TRAIN_LOSSES``
and ``tests/golden_drn_train_graphs.npy`` (10 train steps at B=16, N=2048
from ``ckpts_syn_drn/best.ckpt``; about a minute per step on the CPU);
``port_drn_resume_losses(10)`` is the port's own CPU run of the same steps,
the source of ``chip_smoke.DRN_TRAIN_LATE_RTOL``.
"""

import dataclasses
import functools
import itertools
import os.path as osp
from unittest import mock

import numpy as np
import pytest

from deepmetv2_tpu_torch.models.layout import _leaf
from tests.torch_threads import few_torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
DRN_CKPTS = osp.join(REPO, "ckpts_syn_drn")
DRN_CKPT = osp.join(DRN_CKPTS, "best.ckpt")


def _jax_cfg(batch_size: int = 16, clip: float = 10.0):
    """The run config of ``ckpts_syn_drn`` with its training recipe: the
    global-norm clip and the batch size."""
    from deepmetv2_tpu.cli.common import load_run_config

    cfg = load_run_config(DRN_CKPTS)
    return dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, grad_clip_norm=clip),
        data=dataclasses.replace(cfg.data, batch_size=batch_size))


def _jax_resumed_state(cfg):
    """``ckpts_syn_drn/best.ckpt`` as a JAX TrainState (weights, BatchNorm
    state, the optax chain's clip and AdamW state, step)."""
    import jax

    from deepmetv2_tpu.models.drn import drn_init
    from deepmetv2_tpu.train import checkpoint as jck
    from deepmetv2_tpu.train.step import init_train_state

    template = init_train_state(*drn_init(jax.random.PRNGKey(0), cfg.drn),
                                cfg)
    return jck.load_checkpoint(DRN_CKPT, template=template)


def _jax_fused_train_step(cfg, with_grads: bool = False):
    """The JAX DRN train step (``drn_train_step_core``) on the fused path in
    interpret mode, jitted: ``(state, batch) -> (state, loss, rounds)`` with
    ``rounds`` each round's (mask, idx, slot mask, cluster, partner) as
    ``cut_matching`` sees and returns them, and the gradients after them
    with ``with_grads``."""
    import jax
    import optax

    from deepmetv2_tpu.models.drn import drn_net_apply
    from deepmetv2_tpu.ops import dyn_graph as jdg
    from deepmetv2_tpu.train.loss import drn_loss_fn
    from deepmetv2_tpu.train.step import TrainState, make_optimizer

    opt = make_optimizer(cfg)
    net = functools.partial(
        drn_net_apply, train=True, cfg=cfg.drn, graph_force="fused",
        graph_interpret=True, conv_force="fused", conv_interpret=True)
    match = jdg.cut_matching

    def core(state, batch):
        def objective(params):
            rounds = []

            def recorded(g, h, mask, *a, **kw):
                cluster, partner = match(g, h, mask, *a, **kw)
                rounds.append((mask, g.nbr.idx, g.nbr.mask, cluster,
                               partner))
                return cluster, partner

            # drn_apply imports cut_matching from the module at call time
            with mock.patch.object(jdg, "cut_matching", recorded):
                pred, new_bn = net(params, state.bn_state, batch)
            return drn_loss_fn(pred, batch, cfg.drn.head), (new_bn, rounds)

        (loss, (new_bn, rounds)), grads = jax.value_and_grad(
            objective, has_aux=True)(state.params)
        updates, new_opt = opt.update(grads, state.opt_state, state.params)
        new = TrainState(optax.apply_updates(state.params, updates), new_bn,
                         new_opt, state.step + 1)
        if with_grads:
            return new, loss, rounds, grads
        return new, loss, rounds

    return jax.jit(core)


def _digests(rounds):
    import chip_smoke

    return chip_smoke.drn_graph_digests(
        [[np.asarray(a) for a in r] for r in rounds])


def _train_batches(n_steps: int, jax_side: bool, batch_size: int = 16):
    """The first ``n_steps`` train batches of synthetic 2000 (seed 42,
    split 0.2), unsorted, as both packages' DRN train CLIs feed them."""
    if jax_side:
        from deepmetv2_tpu.data import fetch_dataloader, synthetic_events
    else:
        from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
    ld = fetch_dataloader(events=synthetic_events(2000, seed=42),
                          batch_size=batch_size)["train"]
    return list(itertools.islice(iter(ld), n_steps))


def jax_drn_resume_losses(n_steps: int):
    """The JAX package's per-step DRN train losses from
    ``ckpts_syn_drn/best.ckpt`` on the first ``n_steps`` train batches of
    synthetic 2000 at batch 16, fused path in interpret mode, and each
    step's per-event graph digests ``[n_steps, 16, rounds]``
    (``chip_smoke.drn_graph_digests``): the sources of
    ``chip_smoke.GOLDEN_DRN_TRAIN_LOSSES`` and
    ``tests/golden_drn_train_graphs.npy``."""
    cfg = _jax_cfg()
    state, _ = _jax_resumed_state(cfg)
    step = _jax_fused_train_step(cfg)
    losses, graphs = [], []
    for batch in _train_batches(n_steps, jax_side=True):
        state, loss, rounds = step(state, batch)
        losses.append(float(loss))
        graphs.append(_digests(rounds))
    return losses, np.stack(graphs)


def port_drn_resume_losses(n_steps: int):
    """The port's own run of ``jax_drn_resume_losses`` on the CPU (plain
    versions of the kernels): ``(losses, graphs)`` in the same form."""
    from deepmetv2_tpu_torch.data import to_device

    model, opt, cfg = _port_resumed()
    step = _port_recording_step(cfg)
    losses, graphs = [], []
    for host in _train_batches(n_steps, jax_side=False):
        loss, rounds = step(model, opt, to_device(host, "cpu"))
        losses.append(float(loss))
        graphs.append(_digests([[t.numpy() for t in r] for r in rounds]))
    return losses, np.stack(graphs)


def _port_cfg(batch_size: int = 16, clip: float = 10.0):
    from deepmetv2_tpu_torch.cli.common import load_run_config

    cfg = load_run_config(DRN_CKPTS)
    return dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, grad_clip_norm=clip),
        data=dataclasses.replace(cfg.data, batch_size=batch_size))


def _port_resumed(batch_size: int = 16):
    """(model, optimizer, cfg) resumed from ``ckpts_syn_drn/best.ckpt``."""
    from deepmetv2_tpu_torch.models.drn import DRN
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.step import make_optimizer

    cfg = _port_cfg(batch_size)
    model = DRN(cfg.drn)
    opt = make_optimizer(cfg, model)
    restore_checkpoint(DRN_CKPT, model, opt)
    return model, opt, cfg


def _port_recording_step(cfg):
    """``make_drn_train_step`` that also returns each round's (mask, idx,
    slot mask, cluster, partner) as ``cut_matching`` sees and returns
    them."""
    from deepmetv2_tpu_torch.models import drn as tdrn
    from deepmetv2_tpu_torch.train.step import make_drn_train_step

    step = make_drn_train_step(cfg)
    match = tdrn.cut_matching

    def run(model, opt, batch):
        rounds = []

        def recorded(g, h, mask, *a, **kw):
            cluster, partner = match(g, h, mask, *a, **kw)
            rounds.append((mask, g.nbr.idx, g.nbr.mask, cluster, partner))
            return cluster, partner

        with mock.patch.object(tdrn, "cut_matching", recorded):
            loss = step(model, opt, batch)
        return loss, rounds

    return run


# ------------------------------------------------------------------ tests


def _small_batches(n: int):
    """``n`` batches of 4 synthetic events of 150-400 candidates padded to
    N=512 (the batch of test_torch_drn.py's serving test, then new
    seeds)."""
    from deepmetv2_tpu_torch.data import collate, synthetic_events

    return [collate(synthetic_events(4, seed=3 + i, n_min=150, n_max=400),
                    pad_to=512) for i in range(n)]


def _port_model(params, bn_state, cfg):
    from deepmetv2_tpu_torch.models.drn import DRN

    return DRN(cfg.drn).params_from_jax(params, bn_state)


def _flat_grads(model):
    """The port's gradients as ``{JAX params path: numpy}``."""
    return {path[1:]: t.grad.numpy() for path, t in model.jax_layout()
            if path[0] == "params"}


def _values(model):
    """Every parameter and BatchNorm buffer as ``{JAX path: numpy}``."""
    return {path: t.detach().numpy().copy() for path, t in model.jax_layout()}


# Train mode is ill-conditioned in f32 at ckpts_syn_drn's weights: the
# round-1 BatchNorm variance of some features is 1e-3 of their squared
# mean, so var = Σh²/n − mean² loses about three digits, and the order in
# which each package sums the edge statistics moves the loss by a few 1e-5
# (readings on the 4-event batch below, one step: port against JAX 3.1e-5,
# the port against itself with the statistics summed in another order
# 6.3e-5).  The single step is therefore held at freshly initialized
# weights (drn_init, key 0), where the loss agrees to 2.5e-6, and the
# three resumed steps below at ckpts_syn_drn's with the looser loss bound.
LOSS_RTOL = 1e-5              # one step at init weights (reading 2.5e-6)
RESUMED_LOSS_RTOL = 1e-4      # three steps from the checkpoint (3.1e-5)
# gradients: |got − want| <= GRAD_RTOL·|want| + atol·max|want|, atol
# GRAD_ATOL (readings: at most 8.7e-5 of the tensor's max, datanorm) but
# BN_BIAS_ATOL for each conv's last bias: BatchNorm is invariant to a shift
# of its input, so that bias's gradient is a sum of terms that nearly
# cancel (reading 6.6e-4 of its max; 9.8e-4 at the checkpoint's weights)
GRAD_RTOL, GRAD_ATOL, BN_BIAS_ATOL = 1e-4, 2e-4, 2e-3
# parameters after the three steps (reading 1.9e-6, datanorm) and the
# BatchNorm buffers, atol times the buffer's max (readings: 1.8e-6 after
# three steps, 1.3e-6 after one)
PARAM_ATOL, BN_ATOL = 1e-5, 1e-5


def _assert_close(got, want, rtol, atol, name):
    """``|got − want| <= rtol·|want| + atol·max|want|``."""
    got, want = (np.asarray(v, np.float64) for v in (got, want))
    diff = np.abs(got - want)
    bad = diff > rtol * np.abs(want) + atol * float(np.abs(want).max())
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {got.size} entries "
                           f"differ by up to {float(diff.max())}")


def _port_step(params, bn_state, cfg, host):
    """One forward and backward of the port's DRN in train mode from JAX
    trees: ``(loss, {path: gradient}, {path: value after}, digests)``."""
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.models.drn import drn_net_apply
    from deepmetv2_tpu_torch.train.loss import drn_loss_fn

    model = _port_model(params, bn_state, cfg).train()
    batch = to_device(host, "cpu")
    diag = {}
    loss = drn_loss_fn(drn_net_apply(model, batch, diag), batch,
                       cfg.drn.head)
    loss.backward()
    digests = _digests([[t.numpy() for t in (m, nbr.idx, nbr.mask, c, p)]
                        for m, nbr, c, p in diag["rounds"]])
    return float(loss.detach()), _flat_grads(model), _values(model), digests


def test_drn_train_step_matches_jax():
    """One DRN train-mode forward and backward at freshly initialized
    weights (the JAX package's drn_init, key 0) on 4 events padded to N=512
    against the JAX package's fused path in interpret mode: the same
    graphs, the loss, every gradient, and the BatchNorm buffers after the
    step."""
    import jax

    from deepmetv2_tpu.data.batching import EventBatch as JBatch
    from deepmetv2_tpu.models.drn import drn_init
    from deepmetv2_tpu.train.step import init_train_state

    jcfg, tcfg = _jax_cfg(4), _port_cfg(4)
    (host,) = _small_batches(1)
    params, bn_state = drn_init(jax.random.PRNGKey(0), jcfg.drn)
    state = init_train_state(params, bn_state, jcfg)
    jstate, jloss, jrounds, jgrads = _jax_fused_train_step(
        jcfg, with_grads=True)(state, JBatch(*host))
    loss, grads, after, digests = _port_step(params, bn_state, tcfg, host)
    np.testing.assert_array_equal(digests, _digests(jrounds))
    _assert_close(loss, float(jloss), LOSS_RTOL, 0.0, "loss")
    for path, g in grads.items():
        bn_bias = path[0] == "convs" and path[-2:] == ("lin1", "b")
        _assert_close(g, _leaf(jgrads, path), GRAD_RTOL,
                      BN_BIAS_ATOL if bn_bias else GRAD_ATOL, str(path))
    want = _values(_port_model(jstate.params, jstate.bn_state, tcfg))
    for path, v in after.items():
        if path[0] == "bn_state":
            _assert_close(v, want[path], 0.0, BN_ATOL, str(path))
    for r in range(2):
        assert int(after[("bn_state", "convs", r, 2)]) == int(
            np.asarray(bn_state["convs"][r].count)) + 1


def _port_steps(hosts):
    """The port resumed from ``ckpts_syn_drn/best.ckpt`` and trained on
    ``hosts`` at batch 4: ``(losses, digests, {path: value after})``."""
    from deepmetv2_tpu_torch.data import to_device

    model, opt, cfg = _port_resumed(4)
    step = _port_recording_step(cfg)
    losses, digests = [], []
    for host in hosts:
        loss, rounds = step(model, opt, to_device(host, "cpu"))
        losses.append(float(loss))
        digests.append(_digests([[t.numpy() for t in r] for r in rounds]))
    return losses, digests, _values(model)


def test_drn_three_steps_with_clip_match_jax():
    """Three train steps resumed from ckpts_syn_drn/best.ckpt (its AdamW
    moments and count; clip 10 by global norm) on three batches, through
    ``make_drn_train_step``: the same graphs, the losses, and every
    parameter and BatchNorm buffer after them."""
    from deepmetv2_tpu.data.batching import EventBatch as JBatch

    jcfg, tcfg = _jax_cfg(4), _port_cfg(4)
    hosts = _small_batches(3)
    state, _ = _jax_resumed_state(jcfg)
    jstep = _jax_fused_train_step(jcfg)
    jlosses, jdigests = [], []
    for host in hosts:
        state, jloss, jrounds = jstep(state, JBatch(*host))
        jlosses.append(float(jloss))
        jdigests.append(_digests(jrounds))
    losses, digests, after = _port_steps(hosts)
    for i in range(len(hosts)):
        np.testing.assert_array_equal(digests[i], jdigests[i])
        _assert_close(losses[i], jlosses[i], RESUMED_LOSS_RTOL, 0.0,
                      f"loss of step {i}")
    want = _values(_port_model(state.params, state.bn_state, tcfg))
    for path, v in after.items():
        if path[0] == "params":
            np.testing.assert_allclose(v, want[path], rtol=0,
                                       atol=PARAM_ATOL, err_msg=str(path))
        else:
            _assert_close(v, want[path], 0.0, BN_ATOL, str(path))


def test_resume_drn_checkpoint_with_optax_chain():
    """ckpts_syn_drn/best.ckpt into the port: epoch, scheduler, and the
    optax chain's AdamW moments, count and learning rate as torch AdamW's
    state, datanorm among the trained tensors."""
    from deepmetv2_tpu_torch.models.drn import DRN
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
    from deepmetv2_tpu_torch.train.step import make_optimizer

    jcfg, tcfg = _jax_cfg(), _port_cfg()
    jstate, payload = _jax_resumed_state(jcfg)
    inject = [s for s in jstate.opt_state if hasattr(s, "hyperparams")]
    assert len(inject) == 1 and len(jstate.opt_state) == 2   # clip, adamw
    adam = inject[0].inner_state[0]
    model = DRN(tcfg.drn)
    opt = make_optimizer(tcfg, model)
    sched = ReduceLROnPlateau(lr=1.0)
    got = restore_checkpoint(DRN_CKPT, model, opt, sched)
    assert got["epoch"] == payload["epoch"]
    assert sched.state_dict() == payload["sched_state"]
    assert opt.param_groups[0]["lr"] == float(
        inject[0].hyperparams["learning_rate"])
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    assert id(model.datanorm) in trained
    for path, t in model.jax_layout():
        if path[0] != "params":
            continue
        st = opt.state[t]
        assert int(st["step"]) == int(adam.count) == int(payload["step"])
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      _leaf(adam.mu, path[1:]))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      _leaf(adam.nu, path[1:]))


@pytest.mark.parametrize("fault", [None, "dw1"])
def test_step_check_against_f64_on_cpu(fault):
    """chip_smoke's check of a DRN train step against the port's plain step
    in f64 on the same graphs (``drn_step_against_f64``), run on the CPU on
    4 events from ckpts_syn_drn/best.ckpt: the f32 step passes at the
    card's tolerances, and an f32 backward whose W1 gradient is off by 1 %
    (a fault only the checked run has, as a kernel's would be) fails."""
    import torch

    import chip_smoke
    from deepmetv2_tpu_torch.ops.cuda import edge_mlp as tc

    plain = tc.edge_mlp_bwd_torch

    def faulty(*args):
        gr = plain(*args)
        if gr.dw1.dtype == torch.float32:
            gr = gr._replace(dw1=gr.dw1 * 1.01)
        return gr

    (host,) = _small_batches(1)
    model, opt, cfg = _port_resumed(4)
    with mock.patch.object(tc, "edge_mlp_bwd_torch",
                           faulty if fault else plain):
        if fault:
            with pytest.raises(SystemExit):
                chip_smoke.drn_step_against_f64(model, opt, cfg, host, "cpu")
            return
        loss, rounds, info = chip_smoke.drn_step_against_f64(model, opt, cfg,
                                                             host, "cpu")
    assert len(rounds) == 2 and np.isfinite(loss)
    assert info["loss_rel_err"] <= chip_smoke.DRN_STEP_LOSS_RTOL


def _gaussian_hub(B=2, N=128, H=8, seed=8):
    """Gaussian features with a dense core around row 0, so that the
    fused list is capped (and not symmetric) at the core's rows."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    h[:, :60] *= 0.05
    h[:, 0] = 0.0
    mask = np.ones((B, N), dtype=bool)
    mask[1, N - 9:] = False
    return np.where(mask[..., None], h, 0.0).astype(np.float32), mask


def _lists(case: str):
    """Neighbour lists ``(idx, mask)`` for the mirror tests: 'random' (each
    row distinct random targets, most edges one-sided, an empty row),
    'ring' (symmetric, every slot valid), 'knn_hub' (the port's fused list
    of ``_gaussian_hub``: symmetric but at the capped core)."""
    import torch

    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph

    rng = np.random.default_rng(4)
    if case == "random":
        B, N, K = 2, 48, 6
        idx = np.stack([[rng.permutation(N)[:K] for _ in range(N)]
                        for _ in range(B)]).astype(np.int32)
        mask = rng.random((B, N, K)) < 0.8
        mask[:, 2] = False
        # a fifth of the rows list their first target back
        for b in range(B):
            for i in range(0, N, 5):
                j = int(idx[b, i, 0])
                if mask[b, i, 0] and i not in idx[b, j]:
                    idx[b, j, K - 1], mask[b, j, K - 1] = i, True
        return idx, mask
    if case == "ring":
        N = 32
        off = np.array([1, -1, 2, -2])
        idx = ((np.arange(N)[:, None] + off[None, :]) % N).astype(np.int32)
        return np.stack([idx, idx]), np.ones((2, N, 4), dtype=bool)
    h, mask = _gaussian_hub()
    nbr, _, _ = knn_und_graph(torch.as_tensor(h), torch.as_tensor(mask),
                              k=4, cap=8)
    return nbr.idx.numpy(), nbr.mask.numpy()


def _reverse_listed(idx, mask):
    """``[B, N, K]``: valid slots whose reverse edge is listed and valid."""
    B, N, K = idx.shape
    out = np.zeros_like(mask)
    for b, i, s in zip(*np.nonzero(mask)):
        j = idx[b, i, s]
        out[b, i, s] = bool(np.any((idx[b, j] == i) & mask[b, j]))
    return out


@pytest.mark.parametrize("case", ["random", "ring", "knn_hub"])
def test_mirror_slots_sorted_matches_jax(case):
    """``mirror_slots_sorted`` equals the JAX package's on the same list,
    and each found slot's mirror slot lists the edge back."""
    import jax.numpy as jnp
    import torch

    from deepmetv2_tpu.data.batching import Neighborhood as JNbr
    from deepmetv2_tpu.ops.segment import mirror_slots_sorted as j_mirror
    from deepmetv2_tpu_torch.data.batching import Neighborhood
    from deepmetv2_tpu_torch.ops.segment import mirror_slots_sorted

    idx, mask = _lists(case)
    jm, jf = j_mirror(JNbr(jnp.asarray(idx), jnp.asarray(mask)))
    tm, tf = mirror_slots_sorted(Neighborhood(torch.as_tensor(idx),
                                              torch.as_tensor(mask)))
    assert tm.dtype == torch.int32 and tf.dtype == torch.bool
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    f, m = tf.numpy(), tm.numpy()
    np.testing.assert_array_equal(f, _reverse_listed(idx, mask))
    b, i, s = np.nonzero(f)
    assert np.all(idx[b, idx[b, i, s], m[b, i, s]] == i)
    assert np.all(m[~f] == 0)
    if case == "ring":
        assert f.all()
    else:
        assert 0 < f.sum() < mask.sum()


def test_mirror_slots_sorted_refuses_int32_overflow():
    import torch

    from deepmetv2_tpu_torch.data.batching import Neighborhood
    from deepmetv2_tpu_torch.ops.segment import mirror_slots_sorted

    nbr = Neighborhood(torch.zeros(1, 32768, 1, dtype=torch.int32),
                       torch.ones(1, 32768, 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="int32"):
        mirror_slots_sorted(nbr)


def test_build_dyn_graph_want_mirror_matches_jax():
    """``build_dyn_graph(want_mirror=True)``: the fused list with its mask
    cut to the edges listed both ways, and the mirror table, against the
    JAX package's fused build in interpret mode; the list is symmetric."""
    import jax.numpy as jnp
    import torch

    from deepmetv2_tpu.ops import dyn_graph as jdg
    from deepmetv2_tpu_torch.ops import dyn_graph as tdg

    h, mask = _gaussian_hub()
    jg = jdg.build_dyn_graph(jnp.asarray(h), jnp.asarray(mask), k=4, cap=8,
                             force="fused", interpret=True, want_mirror=True)
    tg = tdg.build_dyn_graph(torch.as_tensor(h), torch.as_tensor(mask), k=4,
                             cap=8, want_mirror=True)
    full = tdg.build_dyn_graph(torch.as_tensor(h), torch.as_tensor(mask), k=4,
                               cap=8)
    np.testing.assert_array_equal(tg.nbr.idx.numpy(), np.asarray(jg.nbr.idx))
    np.testing.assert_array_equal(tg.nbr.mask.numpy(),
                                  np.asarray(jg.nbr.mask))
    np.testing.assert_array_equal(tg.mirror.numpy(), np.asarray(jg.mirror))
    assert full.mirror is None
    idx, m, mir = tg.nbr.idx.numpy(), tg.nbr.mask.numpy(), tg.mirror.numpy()
    assert m.sum() < full.nbr.mask.numpy().sum()     # one-sided slots cut
    np.testing.assert_array_equal(m, _reverse_listed(idx, m))
    b, i, s = np.nonzero(m)
    assert np.all(idx[b, idx[b, i, s], mir[b, i, s]] == i)


def test_drn_data_init_matches_jax(tmp_path):
    """The train CLI's datanorm and output scale from the training split
    against the numbers the JAX CLI hands to ``drn_init``; the polar head's
    MET bias (softplus⁻¹) against ``drn_init``'s."""
    import contextlib
    import io

    import jax
    import torch

    from deepmetv2_tpu.cli import train as j_train
    from deepmetv2_tpu.config import DRNConfig as JDRNConfig
    from deepmetv2_tpu.models import drn as jdrn
    from deepmetv2_tpu_torch.train.family import drn_data_init
    from deepmetv2_tpu_torch.config import DRNConfig
    from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
    from deepmetv2_tpu_torch.models.drn import DRN

    class Stop(Exception):
        pass

    seen = {}

    def record(key, cfg, norm=None, met_bias=0.0, **kw):
        seen.update(norm=norm, met_bias=met_bias, scale=cfg.output_scale)
        raise Stop

    j_init = jdrn.drn_init
    with mock.patch.object(jdrn, "drn_init", record), \
            contextlib.redirect_stdout(io.StringIO()), pytest.raises(Stop):
        j_train.main(["--model", "drn", "--synthetic", "40", "--batch_size",
                      "4", "--ckpts", str(tmp_path)])
    ld = fetch_dataloader(events=synthetic_events(40, seed=42),
                          batch_size=4)["train"]
    norm, met_bias = drn_data_init(ld.dataset, ld.indices)
    np.testing.assert_array_equal(np.asarray(norm), np.asarray(seen["norm"]))
    assert met_bias == seen["met_bias"] == seen["scale"] > 0
    cfg = dict(head="polar", output_scale=7.0)
    jparams, _ = j_init(jax.random.PRNGKey(0), JDRNConfig(**cfg), norm=norm,
                        met_bias=met_bias)
    model = DRN(DRNConfig(**cfg), norm=norm, met_bias=met_bias)
    np.testing.assert_array_equal(model.datanorm.detach().numpy(),
                                  np.asarray(jparams["datanorm"]))
    last = sorted(jparams["output"])[-1]
    np.testing.assert_allclose(float(model.output.layers[-1].b[0].detach()),
                               float(jparams["output"][last]["b"][0]),
                               rtol=1e-6)
    # the cartesian head regresses a zero-mean vector: no bias is set
    gen = [torch.Generator().manual_seed(5) for _ in range(2)]
    cart = [DRN(DRNConfig(head="cartesian"), generator=g, met_bias=m)
            for g, m in zip(gen, (met_bias, 0.0))]
    assert torch.equal(cart[0].output.layers[-1].b, cart[1].output.layers[-1].b)


def test_drn_checkpoint_read_by_jax(tmp_path):
    """A checkpoint the port writes after a train step: the JAX package
    reads it, and its ``drn_net_apply`` (fused path, interpret mode) gives
    the port's evaluation output on another batch; the step count is the
    port's."""
    import torch

    from deepmetv2_tpu.data.batching import EventBatch as JBatch
    from deepmetv2_tpu.models.drn import drn_net_apply as j_apply
    from deepmetv2_tpu.train import checkpoint as jck
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.models.drn import drn_net_apply
    from deepmetv2_tpu_torch.train.checkpoint import save_checkpoint
    from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
    from deepmetv2_tpu_torch.train.step import make_drn_train_step

    hosts = _small_batches(2)
    model, opt, cfg = _port_resumed(4)
    make_drn_train_step(cfg)(model, opt, to_device(hosts[0], "cpu"))
    path = save_checkpoint(model, opt, ReduceLROnPlateau(lr=cfg.optim.lr),
                           epoch=3, is_best=False,
                           checkpoint_dir=str(tmp_path))
    state, payload = jck.load_checkpoint(path)
    assert payload["epoch"] == 3
    assert int(state.step) == int(opt.state[model.datanorm]["step"])
    jpred, _ = j_apply(state.params, state.bn_state, JBatch(*hosts[1]),
                       train=False, cfg=_jax_cfg(4).drn, graph_force="fused",
                       graph_interpret=True, conv_force="fused",
                       conv_interpret=True)
    with torch.no_grad():
        pred = drn_net_apply(model.eval(), to_device(hosts[1], "cpu"))
    jpred = np.asarray(jpred)
    np.testing.assert_allclose(pred.numpy(), jpred, rtol=1e-4,
                               atol=1e-4 * float(np.abs(jpred).max()))


def test_train_cli_drn_runs_on_cpu_and_resumes(tmp_path):
    """``cli.train --model drn --device cpu``: one epoch, then a resume to
    two, on 10 events: every artifact, finite losses, the resumed
    loss.log, and the run config with the data-derived output scale."""
    import json

    from deepmetv2_tpu_torch.cli import train as train_cli
    from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
    from deepmetv2_tpu_torch.train import family

    ck = str(tmp_path / "ck")
    base = ["--model", "drn", "--drn_head", "cartesian", "--synthetic", "10",
            "--batch_size", "4", "--grad_clip", "10", "--bn_refresh", "1",
            "--ckpts", ck, "--device", "cpu"]
    assert train_cli.main(base + ["--epochs", "1"]) == 0
    assert train_cli.main(base + ["--epochs", "2", "--restore_file",
                                  "last"]) == 0
    for f in ("loss.log", "metrics_val_best.json", "metrics_val_last.json",
              "best.resolutions", "last.resolutions", "best.ckpt",
              "last.ckpt", "config.json"):
        assert osp.exists(osp.join(ck, f)), f
    rows = [ln for ln in open(osp.join(ck, "loss.log")) if ln[:1].isdigit()]
    assert [r.split(",")[0] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(x)) for r in rows for x in r.split(",")[1:])
    cfg = json.load(open(osp.join(ck, "config.json")))
    assert cfg["drn"]["head"] == "cartesian"
    assert cfg["optim"]["grad_clip_norm"] == 10.0
    assert not cfg["graph"]["presorted"]
    ld = fetch_dataloader(events=synthetic_events(10, seed=42),
                          batch_size=4)["train"]
    assert cfg["drn"]["output_scale"] == family.drn_data_init(
        ld.dataset, ld.indices)[1]
