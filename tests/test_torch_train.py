"""The port's training path against the JAX package's, on the CPU: train
steps from the same parameters (with and without the global-norm clip), a
resume from the committed JAX checkpoint, the plateau scheduler, the
checkpoint round trip, the recoil loss, the train CLI's flags, and a guard
on the golden losses that ``chip_smoke.py`` holds the card to.

Tolerances: losses agree to rtol 2e-5 and parameters to atol 2e-6 after a
few AdamW steps at lr 1e-3.  Both packages compute in f32 but sum in other
orders (XLA's fused reductions against torch's), which moves a loss of
O(100) by about 1e-6 relative and a parameter by a few ulps of its step;
a wrong gradient, moment or bias correction moves them by 1e-3 or more.

``python -c "from tests.test_torch_train import jax_resume_losses;
print(jax_resume_losses(10))"`` recomputes ``chip_smoke.GOLDEN_TRAIN_LOSSES``,
``jax_nl_resume_losses(10)`` ``chip_smoke.GOLDEN_NL_TRAIN_LOSSES``.
"""

import dataclasses
import itertools
import os.path as osp

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from deepmetv2_tpu.config import Config as JConfig
from deepmetv2_tpu.config import DataConfig as JDataConfig
from deepmetv2_tpu.config import GraphConfig as JGraphConfig
from deepmetv2_tpu.config import OptimConfig as JOptimConfig
from deepmetv2_tpu.data import loader as jl
from deepmetv2_tpu.models.graph_met import graph_met_init as j_init
from deepmetv2_tpu.models.graph_met import net_apply as j_net
from deepmetv2_tpu.train import checkpoint as jck
from deepmetv2_tpu.train.loss import u_perp_par_loss as j_uloss
from deepmetv2_tpu.train.schedule import ReduceLROnPlateau as JPlateau
from deepmetv2_tpu.train.step import build_graph as j_build
from deepmetv2_tpu.train.step import init_train_state, make_train_step
from deepmetv2_tpu.train.step import make_bn_refresh_step as j_refresh
from deepmetv2_tpu_torch.config import Config, DataConfig, GraphConfig
from deepmetv2_tpu_torch.config import OptimConfig
from deepmetv2_tpu_torch.data import loader as tl
from deepmetv2_tpu_torch.data.batching import to_device
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.models.graph_met import GraphMET, net_apply
from deepmetv2_tpu_torch.train import step as tstep
from deepmetv2_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)
from deepmetv2_tpu_torch.train.loss import loss_fn, u_perp_par_loss
from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
from tests.torch_threads import few_torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CKPT = osp.join(REPO, "ckpts_syn", "best.ckpt")
LOSS_RTOL = 2e-5
PARAM_ATOL = 2e-6


def _cell_batches(events, batch_size, buckets, n, loader_mod=tl):
    """The first ``n`` cell-sorted train batches of the seed-42 split."""
    ld = loader_mod.fetch_dataloader(events=events, batch_size=batch_size,
                                     buckets=buckets, presort_eta=True,
                                     presort_mode="cell")["train"]
    return list(itertools.islice(iter(ld), n))


def _configs(halo, batch_size, clip=None):
    g = dict(mode="window", window_halo=halo, presorted=True)
    j = JConfig(graph=JGraphConfig(**g), data=JDataConfig(batch_size=batch_size),
                optim=JOptimConfig(grad_clip_norm=clip))
    t = Config(graph=GraphConfig(**g), data=DataConfig(batch_size=batch_size),
               optim=OptimConfig(grad_clip_norm=clip))
    return j, t


def _jax_steps(state, jcfg, batches):
    step = make_train_step(jcfg)
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(float(loss))
    return state, losses


def _port_steps(model, optimizer, tcfg, batches):
    step = tstep.make_train_step(tcfg)
    return [float(step(model, optimizer, to_device(b, "cpu"))) for b in batches]


def _assert_same_model(model, params, bn_state, n_steps, lr=1e-3):
    """Every parameter and buffer within PARAM_ATOL, except the EdgeConv
    biases: the masked BatchNorm after each EdgeConv removes a constant
    shift per feature, so their gradient is 0 in exact arithmetic and
    rounding noise in f32, which AdamW turns into steps of up to lr of
    either sign.  They, and the running means of those BatchNorms, which
    track them, are held to 2·lr per step."""
    want = GraphMET(model.cfg).params_from_jax(params, bn_state)
    for (path, got), (_, ref) in zip(model.jax_layout(), want.jax_layout()):
        noise = path[1] == "convs" and path[3:] in (("edge", "b"), (0,))
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                   rtol=0, err_msg=str(path),
                                   atol=2 * lr * n_steps if noise
                                   else PARAM_ATOL)


def jax_resume_losses(n_steps: int):
    """The JAX package's per-step train losses from ``ckpts_syn/best.ckpt``
    (loaded with its template) on the first ``n_steps`` cell-sorted train
    batches of synthetic 2000 (seed 42, batch 8, halo 192): the source of
    ``chip_smoke.GOLDEN_TRAIN_LOSSES``."""
    events = synthetic_events(2000, seed=42)
    batches = _cell_batches(events, 8, JDataConfig().node_buckets, n_steps,
                            jl)
    jcfg, _ = _configs(192, 8)
    template = init_train_state(*j_init(jax.random.PRNGKey(0)), jcfg)
    state, _ = jck.load_checkpoint(CKPT, template=template)
    return _jax_steps(state, jcfg, batches)[1]


def jax_nl_resume_losses(n_steps: int):
    """The JAX package's per-step train losses in neighbor_list mode (the
    radius graph capped at 256, self-loops, no phi wrap) from
    ``ckpts_syn/best.ckpt`` on the first ``n_steps`` train batches of
    synthetic 2000 (seed 42, batch 8), unsorted as its train CLI leaves
    them in this mode: the source of
    ``chip_smoke.GOLDEN_NL_TRAIN_LOSSES``."""
    events = synthetic_events(2000, seed=42)
    ld = jl.fetch_dataloader(events=events, batch_size=8)["train"]
    batches = list(itertools.islice(iter(ld), n_steps))
    jcfg = JConfig(data=JDataConfig(batch_size=8))
    template = init_train_state(*j_init(jax.random.PRNGKey(0)), jcfg)
    state, _ = jck.load_checkpoint(CKPT, template=template)
    return _jax_steps(state, jcfg, batches)[1]


@pytest.fixture(scope="module")
def small():
    """Cell-sorted batches of 4 events in the 256 bucket, and their halo."""
    events = synthetic_events(40, seed=3, n_min=60, n_max=250)
    kw = dict(events=events, batch_size=4, buckets=(256,), presort_eta=True,
              presort_mode="cell")
    ld = tl.fetch_dataloader(**kw)["train"]
    halo = max(64, -(-ld.required_halo(0.4) // 64) * 64)
    return _cell_batches(events, 4, (256,), 5), halo


@pytest.mark.parametrize("clip", [None, 1.0])
def test_train_steps_match_jax(small, clip):
    batches, halo = small
    jcfg, tcfg = _configs(halo, 4, clip)
    params, bn_state = j_init(jax.random.PRNGKey(0))
    model = GraphMET(tcfg.model).params_from_jax(params, bn_state)
    if clip is not None:   # the clip fires: the first gradient is larger
        m = GraphMET(tcfg.model).params_from_jax(params, bn_state).train()
        bb, g = tstep.build_graph(to_device(batches[0], "cpu"), tcfg)
        loss_fn(net_apply(m, bb, g), bb).backward()
        assert float(torch.sqrt(sum((p.grad ** 2).sum()
                                    for p in m.parameters()))) > clip
    opt = tstep.make_optimizer(tcfg, model)
    state, jl_ = _jax_steps(init_train_state(params, bn_state, jcfg), jcfg,
                            batches)
    tl_ = _port_steps(model, opt, tcfg, batches)
    np.testing.assert_allclose(tl_, jl_, rtol=LOSS_RTOL)
    assert tl_[-1] < tl_[0]
    _assert_same_model(model, state.params, state.bn_state, len(batches))


def test_resume_from_jax_checkpoint_matches_jax(small):
    batches, halo = small
    jcfg, tcfg = _configs(halo, 4)
    template = init_train_state(*j_init(jax.random.PRNGKey(0)), jcfg)
    jstate, payload = jck.load_checkpoint(CKPT, template=template)
    model = GraphMET(tcfg.model)
    opt = tstep.make_optimizer(tcfg, model)
    sched = ReduceLROnPlateau(lr=1.0)
    got = restore_checkpoint(CKPT, model, opt, sched)
    assert got["epoch"] == payload["epoch"] == 73
    assert sched.state_dict() == payload["sched_state"]
    st = opt.state[model.encode_all.w]
    assert int(st["step"]) == int(payload["step"]) == 14600
    np.testing.assert_array_equal(
        st["exp_avg"].numpy(),
        payload["opt_state"].inner_state[0].mu["encode_all"]["w"])
    jstate, jl_ = _jax_steps(jstate, jcfg, batches[:3])
    tl_ = _port_steps(model, opt, tcfg, batches[:3])
    np.testing.assert_allclose(tl_, jl_, rtol=LOSS_RTOL)
    _assert_same_model(model, jstate.params, jstate.bn_state, 3)


def test_bn_refresh_matches_jax(small):
    """One precise-BN pass: running statistics updated from the batch's,
    parameters untouched (atol 1e-5, the forward's tolerance)."""
    batches, halo = small
    jcfg, tcfg = _configs(halo, 4)
    params, bn_state = j_init(jax.random.PRNGKey(2))
    new_bn = j_refresh(jcfg)(params, bn_state, batches[0])
    model = GraphMET(tcfg.model).params_from_jax(params, bn_state)
    before = [t.detach().clone() for _, t in model.jax_layout()]
    tstep.make_bn_refresh_step(tstep.graphmet_objective(tcfg))(
        model, to_device(batches[0], "cpu"))
    want = GraphMET(tcfg.model).params_from_jax(params, new_bn)
    for (path, got), (_, ref), old in zip(model.jax_layout(),
                                          want.jax_layout(), before):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                   rtol=0, atol=1e-5, err_msg=str(path))
        assert torch.equal(got, old) == (path[0] == "params"), path


def test_plateau_scheduler_matches_jax():
    rng = np.random.default_rng(0)
    metrics = list(100 * np.exp(-np.arange(30) / 10.0)
                   * (1 + 0.1 * rng.normal(size=30)))
    metrics += [metrics[-1]] * 10
    kw = dict(lr=1e-3, factor=0.5, patience=3, threshold=0.05, cooldown=1)
    j, t = JPlateau(**kw), ReduceLROnPlateau(**kw)
    for m in metrics:
        assert t.step(m) == j.step(m)
        assert t.state_dict() == j.state_dict()
    assert t.lr < 1e-3


def test_checkpoint_roundtrip(small, tmp_path):
    batches, halo = small
    _, tcfg = _configs(halo, 4, clip=1.0)
    model = GraphMET(tcfg.model, generator=torch.Generator().manual_seed(2))
    opt = tstep.make_optimizer(tcfg, model)
    sched = ReduceLROnPlateau(lr=1e-3, patience=0)
    _port_steps(model, opt, tcfg, batches[:2])
    sched.step(5.0), sched.step(6.0)
    tstep.set_learning_rate(opt, sched.lr)
    path = save_checkpoint(model, opt, sched, epoch=4, is_best=True,
                           checkpoint_dir=str(tmp_path))
    assert osp.basename(path) == "best.ckpt"

    model2 = GraphMET(tcfg.model)
    opt2 = tstep.make_optimizer(tcfg, model2)
    sched2 = ReduceLROnPlateau(lr=1.0)
    payload = restore_checkpoint(path, model2, opt2, sched2)
    assert payload["epoch"] == 4 and payload["step"] == 2
    assert sched2.state_dict() == sched.state_dict() and sched2.lr == 5e-4
    for (p, a), (_, b) in zip(model.jax_layout(), model2.jax_layout()):
        assert torch.equal(a, b), p
    for p, p2 in zip(model.parameters(), model2.parameters()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], opt2.state[p2][k]), k
    assert opt2.param_groups[0]["lr"] == 5e-4
    # the same next step, bit for bit
    assert (_port_steps(model, opt, tcfg, batches[2:3])
            == _port_steps(model2, opt2, tcfg, batches[2:3]))


def test_u_perp_par_loss_matches_jax(small):
    batches, halo = small
    jcfg, tcfg = _configs(halo, 4)
    params, bn_state = j_init(jax.random.PRNGKey(1))
    jb, jg = j_build(batches[0], jcfg)
    jw, _ = j_net(params, bn_state, jb, jg, train=False)
    want = float(j_uloss(jw, jb))
    tb = to_device(batches[0], "cpu")
    got = float(u_perp_par_loss(torch.tensor(np.asarray(jw)), tb))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("flags", [["--model", "drn", "--mesh", "1x2"],
                                   ["--mesh", "2"], ["--ring_knn"],
                                   ["--model", "drn", "--ring_knn"],
                                   ["--model", "drn", "--compute_dtype",
                                    "bfloat16"],
                                   ["--compute_dtype", "bfloat16"]])
def test_train_cli_unported_flags_exit_nonzero(flags, tmp_path):
    from deepmetv2_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--synthetic", "4", "--ckpts", str(tmp_path),
                        "--device", "cpu"] + flags)
    assert exc.value.code not in (0, None)
    assert "not ported yet" in str(exc.value.code)


def test_train_cli_needs_a_gpu_unless_cpu(tmp_path):
    from deepmetv2_tpu_torch.cli import train as train_cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device works")
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--synthetic", "4", "--ckpts", str(tmp_path)])
    assert exc.value.code not in (0, None)
    assert "no CUDA GPU" in str(exc.value.code)


def test_golden_train_losses_guard():
    """The first two of chip_smoke.GOLDEN_TRAIN_LOSSES, recomputed with the
    JAX package and with the port on the CPU (rtol 1e-4, the smoke
    test's limit on the card)."""
    golden = chip_smoke.GOLDEN_TRAIN_LOSSES
    assert len(golden) == 10
    want = jax_resume_losses(2)
    np.testing.assert_allclose(want, golden[:2], rtol=1e-6)
    events = synthetic_events(2000, seed=42)
    batches = _cell_batches(events, 8, DataConfig().node_buckets, 2)
    _, tcfg = _configs(192, 8)
    model = GraphMET(tcfg.model)
    opt = tstep.make_optimizer(tcfg, model)
    restore_checkpoint(CKPT, model, opt)
    got = _port_steps(model, opt, tcfg, batches)
    np.testing.assert_allclose(got, golden[:2], rtol=chip_smoke.LOSS_RTOL)


def test_train_cli_runs_on_cpu_and_resumes(tmp_path):
    """One epoch, then a resume to two, on 40 events: every artifact,
    finite losses, and a resumed loss.log."""
    import json

    from deepmetv2_tpu_torch.cli import train as train_cli

    ck = str(tmp_path / "ck")
    base = ["--synthetic", "40", "--batch_size", "4", "--ckpts", ck,
            "--device", "cpu"]
    assert train_cli.main(base + ["--epochs", "1"]) == 0
    assert train_cli.main(base + ["--epochs", "2", "--restore_file",
                                  "last"]) == 0
    for f in ("loss.log", "metrics_val_best.json", "metrics_val_last.json",
              "best.resolutions", "last.resolutions", "best.ckpt",
              "last.ckpt", "config.json"):
        assert osp.exists(osp.join(ck, f)), f
    rows = [ln for ln in open(osp.join(ck, "loss.log"))
            if ln[:1].isdigit()]
    assert [r.split(",")[0] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(x)) for r in rows for x in r.split(",")[1:])
    cfg = json.load(open(osp.join(ck, "config.json")))
    assert cfg["graph"]["presorted"] and cfg["graph"]["mode"] == "window"
    assert dataclasses.asdict(GraphConfig())["delta_r"] == cfg["graph"]["delta_r"]
