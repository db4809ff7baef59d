"""The plain references against the port at tiny sizes on the CPU (the
tests may import both; the references import nothing of the port)."""

import dataclasses

import numpy as np
import torch

from portbench import weights
from portbench.families import drn as fam_drn
from portbench.families import graphmet as fam_gm
from portbench.faults import patched
from portbench.entries import train as train_entry
from portbench.gen import events as gen
from portbench.reference import drn as ref_drn
from portbench.reference import graphmet as ref_gm
from portbench.reference.common import Precision, Steps, tf32_round
from portbench.tests.test_gen import traffic

from deepmetv2_tpu_torch.config import (Config, DRNConfig, GraphConfig)
from deepmetv2_tpu_torch.data.batching import (Neighborhood, collate,
                                               to_device)
from deepmetv2_tpu_torch.data.sorting import required_halo_events
from deepmetv2_tpu_torch.models.drn import DRN, drn_net_apply
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.ops import dyn_graph
from deepmetv2_tpu_torch.ops.coarsen import (handshake_matching,
                                             normalized_cut_weights)
from deepmetv2_tpu_torch.train.loss import drn_met_vector
from deepmetv2_tpu_torch.train.step import (make_eval_step, make_optimizer,
                                            make_train_step)

BUCKETS = (128, 256, 512)


def small_events(n=8, seed=3):
    t = traffic(events=n, batch=4)
    t["candidates"] = dict(t["candidates"], min=60, max=240)
    return gen.make_events(t, seed)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12,
                      -(1.0 + 2 ** -11 + 2 ** -13), float("inf")])
    got = tf32_round(x)
    want = torch.tensor([1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10,
                         -(1.0 + 2 ** -10), float("inf")])
    assert torch.equal(got, want)


def test_graphmet_eval_against_the_port():
    ev = small_events()
    halo = max(64, -(-required_halo_events(ev, 0.4) // 64) * 64)
    cfg = Config(graph=GraphConfig(mode="window", window_halo=halo))
    leaves = weights.make(fam_gm.weight_spec(
        dataclasses.asdict(cfg.model)), 3, "cpu")
    model = GraphMET(cfg.model)
    model.load_state_dict(leaves)
    host = collate(ev[:4], BUCKETS, pad_events_to=4)
    v, _, w = make_eval_step(cfg)(model, to_device(host, "cpu"))
    b = ref_gm.make_batch(ev[:4], 0.4, "cpu")
    wr = ref_gm.forward(leaves, b, 2, False)
    wp = torch.cat([w[i, :len(x)] for i, (x, _) in enumerate(ev[:4])])
    assert float((wp - wr).abs().max()) < 1e-6
    assert float((v - ref_gm.met(wr, b)).abs().max()) < 1e-4


def test_graphmet_train_steps_against_the_port():
    ev = small_events()
    halo = max(64, -(-required_halo_events(ev, 0.4) // 64) * 64)
    cfg = Config(graph=GraphConfig(mode="window", window_halo=halo))
    cfgj = dataclasses.asdict(cfg)
    leaves = weights.make(fam_gm.weight_spec(cfgj["model"]), 3, "cpu")
    model = GraphMET(cfg.model)
    model.load_state_dict(leaves)
    opt = make_optimizer(cfg, model)
    first = train_entry.FirstStep(model, opt)
    step = make_train_step(cfg)
    losses = [step(model, opt, to_device(collate(ev[i:i + 4], BUCKETS,
                                                 pad_events_to=4), "cpu"))
              for i in (0, 4)]
    names = {p: k for k, p in model.named_parameters()}
    port = Steps(torch.stack(losses).double().tolist(),
                 {k: v.double() / 0.1 for k, v in first.moment.items()},
                 [{k: v.double() for k, v in first.params.items()},
                  {k: p.detach().double() for p, k in names.items()}],
                 {k: v.double() for k, v in train_entry.state_of(
                     opt, names, "exp_avg").items()}, [], [])
    batches = [ref_gm.make_batch(ev[i:i + 4], 0.4, "cpu") for i in (0, 4)]
    ref = ref_gm.train_steps(leaves, batches, cfgj)
    notes = []
    got = train_entry.compare(port, ref, leaves, notes)
    assert got["loss_rel"] < 1e-6
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-4
    assert got["chain_change"] < 1e-3 and got["chain_moment"] < 1e-3
    assert any("convs.0.edge.b" in n for n in notes)   # gradient ~ 0


def test_restart_brings_back_the_seed_state():
    ev = small_events()
    halo = max(64, -(-required_halo_events(ev, 0.4) // 64) * 64)
    cfg = Config(graph=GraphConfig(mode="window", window_halo=halo))
    leaves = weights.make(fam_gm.weight_spec(
        dataclasses.asdict(cfg.model)), 3, "cpu")
    model = GraphMET(cfg.model)
    model.load_state_dict(leaves)
    opt = make_optimizer(cfg, model)
    step = make_train_step(cfg)
    batch = to_device(collate(ev[:4], BUCKETS, pad_events_to=4), "cpu")
    before = float(step(model, opt, batch))
    held = {k: v for k, v in model.state_dict().items()}
    step(model, opt, batch)
    train_entry.restart(model, opt, leaves)
    for k, v in model.state_dict().items():
        assert v is held[k] or v.data_ptr() == held[k].data_ptr()
        assert torch.equal(v, leaves[k])
    assert float(step(model, opt, batch)) == before


def test_matching_gap_finds_a_wrong_matching():
    torch.manual_seed(0)
    h = torch.randn(400, 64)
    lists = ref_drn.knn_lists(h, 16, 32)
    nbr = Neighborhood(lists.idx[None], lists.valid[None])
    mask = torch.ones(1, 400, dtype=torch.bool)
    w = normalized_cut_weights(h[None], nbr)

    def gap(partner):
        return ref_drn.match_gap(ref_drn.match_sums(h, lists, partner)[None])

    assert gap(handshake_matching(w, nbr, mask)[1][0]) < 1e-6
    assert gap(torch.arange(400)) == 1.0                      # none matched
    assert gap(handshake_matching(w, nbr, mask, rounds=1)[1][0]) > 0.05
    lightest = torch.where(torch.isfinite(w), -w, w)
    assert gap(handshake_matching(lightest, nbr, mask)[1][0]) > 0.05


def test_drn_follows_the_port_and_finds_no_fault():
    ev = small_events(4)
    cfg = DRNConfig(head="cartesian", output_scale=100.0)
    cfgj = dataclasses.asdict(cfg)
    leaves = weights.make(fam_drn.weight_spec(cfgj), 3, "cpu",
                          {"datanorm": [0.5] * 11})
    model = DRN(cfg)
    model.load_state_dict(leaves)
    model.eval()
    host = collate(ev, BUCKETS, pad_events_to=4)
    diag = {}
    with torch.no_grad(), patched(dyn_graph, "DENSE_MATCH_MAX_N", 0), \
            patched(dyn_graph, "DENSE_W_MAX_ELEMS", 0):   # the cells' branch
        v = drn_met_vector(drn_net_apply(model, to_device(host, "cpu"),
                                         diag), "cartesian")
    N = host.mask.shape[1]
    for i, (x, _) in enumerate(ev):
        dec = [ref_drn.Decisions(m[i], ref_drn.Lists(nb.idx[i], nb.mask[i]),
                                 c[i], p[i]) for m, nb, c, p in diag["rounds"]]
        met, faults, sums = ref_drn.follow(leaves, ref_drn.Event(
            torch.as_tensor(x), N), dec, cfgj, Precision(), 1e-4)
        assert faults == 0 and ref_drn.match_gap(sums) < 0.05
        assert float((met - v[i]).abs().max()) < 1e-5 * float(
            met.abs().max()) + 1e-4
        # a planted wrong neighbour is a fault
        bad = [d._replace(lists=ref_drn.Lists(
            torch.where(d.lists.valid, (d.lists.idx + 7) % len(x),
                        d.lists.idx), d.lists.valid)) for d in dec]
        assert ref_drn.follow(leaves, ref_drn.Event(torch.as_tensor(x), N),
                              bad, cfgj, Precision(), 1e-4)[1] > 0


def test_drn_own_graph_counts_work():
    ev = small_events(2)
    cfgj = dataclasses.asdict(DRNConfig(head="cartesian"))
    leaves = weights.make(fam_drn.weight_spec(cfgj), 3, "cpu",
                          {"datanorm": [0.5] * 11})
    met, work = ref_drn.own(leaves, ref_drn.Event(
        torch.as_tensor(ev[0][0]), 256), cfgj)
    assert np.isfinite(met.numpy()).all()
    assert work[0]["n"] == len(ev[0][0]) and work[1]["n"] < work[0]["n"]
    assert 16 * work[0]["n"] <= work[0]["edges"] <= 32 * work[0]["n"]


def test_routed_poolings_send_the_gradient_where_the_run_did():
    torch.manual_seed(1)
    h = torch.randn(6, 3, dtype=torch.float64)
    h[1, 0] = h[0, 0] + 1e-9                     # a near tie, row 1 ahead here
    prow = torch.tensor([1, 0, 2, 4, 3, 5])
    hp = h.clone()
    hp[0, 0] = hp[1, 0] + 1e-9                   # the run put row 0 ahead
    x = h.clone().requires_grad_(True)
    pooled, run, faults = ref_drn.routed_pool(x, hp, prow, 1e-4)
    assert faults == 0 and torch.equal(run, torch.maximum(hp, hp[prow]))
    pooled[0, 0].backward()
    assert x.grad[0, 0] == 1 and x.grad[1, 0] == 0
    wrong = hp.clone()
    wrong[2:4] = -wrong[2:4]                      # far from any tie
    wrong[3] = wrong[4] - 1
    assert ref_drn.routed_pool(h, wrong, prow, 1e-4)[2] > 0

    x = h.clone().requires_grad_(True)
    top = int(h[:, 1].argmax())
    other = (top + 1) % 6
    hp = h.clone()
    hp[other, 1] = hp[top, 1] + 1e-9
    x2 = h.clone()
    x2[other, 1] = h[top, 1] - 1e-9               # the tie, here the other way
    x = x2.requires_grad_(True)
    g, faults = ref_drn.routed_max(x, hp, 1e-4)
    assert faults == 0
    g[1].backward()
    assert x.grad[other, 1] == 1 and x.grad[top, 1] == 0
    far = h.clone()
    far[other, 1] = h[top, 1] + 5                 # the run's max is no max here
    assert ref_drn.routed_max(h, far, 1e-4)[1] == 1


def test_deterministic_sets_the_mode_and_restores_it():
    import pytest

    from portbench import cell

    assert not torch.are_deterministic_algorithms_enabled()
    with cell.deterministic():
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(KeyError):
        with cell.deterministic():
            raise KeyError("x")
    assert not torch.are_deterministic_algorithms_enabled()


def test_the_references_run_in_a_fixed_order_and_the_window_does_not():
    """The checks' references (a serving cell's check, a training cell's
    reference steps) run under ``cell.deterministic``; the port's steps
    before them do not."""
    from deepmetv2_tpu_torch.train import step as port_step
    from portbench import cell
    from portbench.tests.tiny import run_tiny

    modes = {"ref": [], "port": []}

    def seen(key, fn):
        def wrapped(*a, **k):
            modes[key].append(torch.are_deterministic_algorithms_enabled())
            return fn(*a, **k)
        return wrapped

    with patched(cell, "met_rel", seen("ref", cell.met_rel)), \
            patched(port_step, "loss_fn", seen("port", port_step.loss_fn)), \
            patched(ref_gm, "train_steps", seen("ref", ref_gm.train_steps)):
        for name in ("graphmet-infer-cms", "graphmet-train-cms"):
            assert run_tiny(name)[1]["correct"]
    assert modes["ref"] and all(modes["ref"])
    assert modes["port"] and not any(modes["port"])
