"""ParticleNet on the port's normal path, on the CPU at small sizes:
published widths (64/128/256), N <= 256, two events, seeded weights.

* the directed kNN extraction against a brute-force (d², index) top-k at
  the three point widths ParticleNet's blocks use, with padded rows and
  ties, and the undirected extraction unchanged;
* the port's model (ops/pn_edge.py's plain edge block) against the plain
  reference ``portbench/reference/particlenet.py`` on the same weights,
  the run's own lists and dropout mask: forward MET, loss, every leaf's
  gradient and one AdamW step; the reference with TF32 operands breaks at
  least one of those tolerances;
* a chained train step equal to eager steps, the ``particlenet`` config
  section's round trip, and ``cli.train --model particlenet``.
"""

import json
import math

import numpy as np
import pytest
import torch

from deepmetv2_tpu_torch.config import Config, ParticleNetConfig
from deepmetv2_tpu_torch.data.batching import collate, to_device
from deepmetv2_tpu_torch.models.particlenet import (ParticleNet,
                                                    particlenet_net_apply)
from deepmetv2_tpu_torch.ops import knn_und as tk
from deepmetv2_tpu_torch.train.chain import (make_chained_train_step,
                                             stack_batches)
from deepmetv2_tpu_torch.train.loss import drn_loss_fn
from deepmetv2_tpu_torch.train.step import (make_optimizer, make_train_step,
                                            particlenet_objective)
from portbench import weights
from portbench.families import particlenet as fam
from portbench.gen import events as gen
from portbench.reference import particlenet as ref
from portbench.reference.common import Precision
from portbench.reference.graphmet import AdamW, trainable
from portbench.tests.test_gen import traffic
from tests.torch_threads import few_torch_threads  # noqa: F401

K = 16
PN = dict(input_dim=11, k=K, conv_params=[[64, 64, 64], [128, 128, 128],
                                          [256, 256, 256]],
          fc=256, dropout=0.1, output_scale=100.0)
OPTIM = dict(lr=1e-3, betas=[0.9, 0.999], eps=1e-8, weight_decay=0.01,
             grad_clip_norm=None)


def pn_config(batch: int = 2) -> Config:
    return Config.from_json(json.dumps({
        "particlenet": PN, "optim": OPTIM,
        "data": {"batch_size": batch, "node_buckets": [128, 256]}}))


def small_events(n: int = 2, seed: int = 5):
    t = traffic(events=n, batch=n)
    t["candidates"] = dict(t["candidates"], min=60, max=240)
    return gen.make_events(t, seed)


# ----------------------------------------------------------------- kNN


def brute_directed(h, mask, k):
    """Per real row, its k nearest other real rows by (d², index), with
    d² as ops/knn_und.py computes it."""
    out = []
    for b in range(h.shape[0]):
        n = int(mask[b].sum())
        d2 = tk.event_d2(h[b], tk.sq_norms(h)[b])
        out.append([sorted((float(d2[i, j]), j) for j in range(n)
                           if j != i)[:k] for i in range(n)])
    return out


@pytest.mark.parametrize("H", [2, 64, 128])
def test_directed_extraction_is_each_rows_k_nearest(H):
    gen_ = torch.Generator().manual_seed(H)
    B, N = 2, 128
    h = torch.randn((B, N, H), generator=gen_)
    h[:, 30:36] = h[:, 10:16]                       # tied distances
    mask = torch.arange(N)[None] < torch.tensor([[100], [14]])
    t, sq = tk.knn_kth_torch(h, mask, K)
    idx, d2v, rel = tk.knn_extract_torch(h, mask, t, sq, K, True, True)
    nbr, _ = tk.neighborhood(idx, d2v, mask)
    want = brute_directed(h, mask, K)
    for b in range(B):
        n = int(mask[b].sum())
        assert not nbr.mask[b, n:].any()
        assert not rel[b, n:].any()
        for i in range(n):
            got = [(float(d2v[b, i, s]), int(idx[b, i, s]))
                   for s in range(K) if nbr.mask[b, i, s]]
            assert got == want[b][i], (b, i)
            # the relation is d² <= t_i alone
            assert int(rel[b, i].sum()) >= len(got)
    # an event of 14 candidates lists its 13 others at every row
    assert (nbr.mask[1, :14].sum(-1) == 13).all()


def test_undirected_extraction_is_unchanged():
    """The default (undirected) call is the relation d² <= t_i or
    d² <= t_j, its first cap members in (d², index) order, as before."""
    gen_ = torch.Generator().manual_seed(1)
    B, N, H, cap = 2, 128, 8, 32
    h = torch.randn((B, N, H), generator=gen_)
    mask = torch.arange(N)[None] < torch.tensor([[128], [70]])
    t, sq = tk.knn_kth_torch(h, mask, K)
    a = tk.knn_extract_torch(h, mask, t, sq, cap, True)
    b_ = tk.knn_extract_torch(h, mask, t, sq, cap, True, directed=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b_))
    for b in range(B):
        d2 = tk.event_d2(h[b], sq[b])
        u = ((d2 <= t[b][:, None]) | (d2 <= t[b][None, :]))
        u &= mask[b][None, :] & mask[b][:, None]
        u.fill_diagonal_(False)
        assert torch.equal(a[2][b], u)
        vals, order = torch.sort(torch.where(u, d2, math.inf), dim=-1,
                                 stable=True)
        fin = torch.isfinite(vals[:, :cap])
        assert torch.equal(a[1][b], vals[:, :cap])
        assert torch.equal(a[0][b], torch.where(
            fin, order[:, :cap], 0).to(torch.int32))


# ------------------------------------------------- model and reference


def port_step(seed: int = 11):
    """One eager train step of the port from the seed's weights: its
    loss, MET, gradients, parameters after AdamW, and the lists and
    dropout mask it used; the events and the leaves."""
    events = small_events()
    cfg = pn_config()
    leaves = weights.make(fam.weight_spec(PN), seed, "cpu")
    model = ParticleNet(cfg.particlenet)
    model.load_state_dict(leaves)
    leaves = weights.clone(leaves)
    model.log_forwards(1)
    batch = to_device(collate(events, (128, 256)), "cpu")
    opt = make_optimizer(cfg, model)
    model.train()
    torch.manual_seed(seed)
    met = particlenet_net_apply(model, batch)
    loss = drn_loss_fn(met, batch, "cartesian")
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for p, g in zip(model.parameters(), grads):
        p.grad = g
    opt.step()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    lists, keep = model.logged(0, batch.mask.shape[0], batch.mask.shape[1])
    return dict(events=events, leaves=leaves, loss=float(loss.detach()),
                met=met.detach(), grads=dict(zip(names, grads)),
                params=params, lists=lists, keep=keep)


def ref_batch(run):
    xs = [torch.as_tensor(x) for x, _ in run["events"]]
    per_event = [[ref.Lists(nb.idx[e, :x.shape[0]], nb.mask[e, :x.shape[0]])
                  for nb in run["lists"]] for e, x in enumerate(xs)]
    gen_met = torch.as_tensor(np.stack([y[:2] for _, y in run["events"]]))
    return ref.Batch(xs, gen_met, per_event, run["keep"])


def reference_side(run, prec: Precision):
    """The reference's MET, loss, gradients and parameters after AdamW
    from the same leaves, on the run's lists and mask."""
    bt = ref_batch(run)
    params = {k: v.clone().requires_grad_(True)
              for k, v in run["leaves"].items() if trainable(k)}
    fixed = {k: v for k, v in run["leaves"].items() if not trainable(k)}
    met = ref.forward({**params, **fixed}, bt.events, bt.lists, bt.keep, PN,
                      prec)
    loss = 0.5 * ((met - bt.gen) ** 2).sum(1).mean()
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    opt = AdamW(params, OPTIM["lr"], tuple(OPTIM["betas"]), OPTIM["eps"],
                OPTIM["weight_decay"])
    opt.step(grads)
    return dict(met=met.detach(), loss=float(loss.detach()), grads=grads,
                params={k: v.detach() for k, v in params.items()})


def gaps(run, other):
    """The compared numbers: the worst MET gap over the largest MET, the
    loss's relative gap, the worst leaf's gradient gap (its difference's
    norm over the larger of its norm and the median leaf's), and the median
    leaf's gap in the change AdamW's step made."""
    met = float((run["met"] - other["met"]).abs().max()
                / other["met"].abs().max())
    loss = abs(run["loss"] - other["loss"]) / abs(other["loss"])
    norms = {k: float(g.norm()) for k, g in other["grads"].items()}
    med = float(np.median(list(norms.values())))
    grad = max(float((run["grads"][k] - g).norm()) / max(norms[k], med)
               for k, g in other["grads"].items())
    changes = []
    for k, p in other["params"].items():
        want = p - run["leaves"][k]
        got = run["params"][k] - run["leaves"][k]
        changes.append(float((got - want).norm())
                       / max(float(want.norm()), 1e-30))
    return dict(met=met, loss=loss, grad=grad,
                change=float(np.median(changes)))


# Both sides compute in float32 in different orders (the port factors the
# first edge layer and sums BatchNorm statistics per tile, the reference
# concatenates [x_i, x_j - x_i]).  Rounding of ~1e-7 per operation reaches
# the MET and the loss as ~2e-7 (measured).  A weight's gradient is a sum
# over every edge or candidate of terms that the BatchNorm backward makes
# cancel (two events: the batch statistics nearly fix the output), so its
# elements keep fewer digits: the worst leaf's difference reads 2.6e-3 of
# its norm (measured), TF32 operands 4.9e-2.  AdamW's first step moves every
# element by about lr times the sign of its gradient, so the median leaf's
# change agrees up to the few elements whose gradient is at rounding level
# (9e-8 measured; TF32 0.2).
TOL = dict(met=2e-5, loss=2e-5, grad=1e-2, change=1e-3)


@pytest.fixture(scope="module")
def run():
    return port_step()


def test_port_matches_the_reference(run):
    g = gaps(run, reference_side(run, Precision()))
    assert all(g[k] <= TOL[k] for k in TOL), g


def test_tf32_control_breaks_a_tolerance(run):
    g = gaps(run, reference_side(run, Precision(tf32=True)))
    assert any(g[k] > TOL[k] for k in TOL), g


def test_logged_lists_are_the_reference_own(run):
    """The run's lists hold no fault on the reference's own points."""
    bt = ref_batch(run)
    pts = ref.block_points(run["leaves"], bt.events, bt.lists, PN,
                           Precision())
    assert sum(ref.check_lists(pts[e][b], bt.lists[e][b], K, 1e-4)
               for e in range(len(bt.events)) for b in range(3)) == 0
    # and they are its own float64 kNN lists, up to near ties
    own = ref.own_lists(pts[0][0], K)
    assert torch.equal(torch.sort(own.idx, 1).values,
                       torch.sort(bt.lists[0][0].idx.long(), 1).values)


# ------------------------------------------------------ the normal path


def test_chained_step_equals_eager_steps():
    cfg = pn_config()
    events = small_events(6, seed=9)
    batches = [collate(events[i:i + 2], (128, 256)) for i in (0, 2, 4)]
    batches = [b for b in batches if b.mask.shape == batches[0].mask.shape]
    leaves = weights.make(fam.weight_spec(PN), 3, "cpu")

    def trained(chained: bool):
        model = ParticleNet(cfg.particlenet)
        model.load_state_dict(leaves)
        opt = make_optimizer(cfg, model)
        torch.manual_seed(0)
        if chained:
            step = make_chained_train_step(cfg, "particlenet")
            losses = step(model, opt, to_device(stack_batches(batches),
                                                "cpu"))
        else:
            step = make_train_step(cfg, particlenet_objective(cfg))
            losses = torch.stack([step(model, opt, to_device(b, "cpu"))
                                  for b in batches])
        return losses, {k: v.clone() for k, v in model.state_dict().items()}

    (l0, s0), (l1, s1) = trained(False), trained(True)
    assert len(batches) >= 2
    assert torch.equal(l0, l1)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_config_round_trips_a_particlenet_section():
    cfg = pn_config()
    assert cfg.particlenet == ParticleNetConfig(
        conv_params=((64, 64, 64), (128, 128, 128), (256, 256, 256)),
        output_scale=100.0)
    assert cfg.particlenet.fusion == 384          # weaver's rule on 448
    assert ParticleNetConfig(conv_params=((64,) * 3,)).fusion == 128
    assert Config.from_json(cfg.to_json()) == cfg
    raw = json.loads(cfg.to_json())
    assert raw["particlenet"]["conv_params"][2] == [256, 256, 256]
    with open("portbench/configs/particlenet-k16-f32.json") as f:
        file_cfg = Config.from_json(f.read())
    assert file_cfg.particlenet == cfg.particlenet


def test_train_cli_runs_two_steps(tmp_path, monkeypatch, capsys):
    from deepmetv2_tpu_torch.cli import train as cli_train

    monkeypatch.setattr(cli_train, "synthetic_events",
                        lambda n, seed=42: small_events(n, seed))
    ck = tmp_path / "ck"
    assert cli_train.main(["--model", "particlenet", "--synthetic", "10",
                           "--batch_size", "4", "--epochs", "1",
                           "--ckpts", str(ck), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "particlenet: output scale" in out
    assert "Training epoch: 01" in out
    assert (ck / "last.ckpt").exists()
    cfg = json.loads((ck / "config.json").read_text())
    assert cfg["particlenet"]["conv_params"][0] == [64, 64, 64]
