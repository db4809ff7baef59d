"""The table of model families (``train/family.py``) and the names the
benchmark patches, on the CPU on two tiny events (60–240 candidates):

* both parsers offer the table's keys as ``--model``, default GraphMET;
* ``fit``'s lookup finds each row from a model of its class;
* each name that ``portbench/record.py``, ``portbench/faults.py`` and the
  benchmark's family files patch is looked up at call time through the
  module they patch: patching it after the step is made changes what the
  family's objective or eval step returns (``ChainedStep.__call__``: the
  patch runs).
"""

import dataclasses
import importlib

import pytest
import torch

from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
from deepmetv2_tpu_torch.cli import predict as predict_cli
from deepmetv2_tpu_torch.cli import train as train_cli
from deepmetv2_tpu_torch.cli.common import load_run_config
from deepmetv2_tpu_torch.config import Config
from deepmetv2_tpu_torch.data.batching import collate, to_device
from deepmetv2_tpu_torch.train import chain as tchain
from deepmetv2_tpu_torch.train.family import (DEFAULT, FAMILIES, family,
                                              mesh_forms, of_model)
from deepmetv2_tpu_torch.train.step import make_optimizer
from portbench.gen import events as gen
from portbench.tests.test_gen import traffic
from tests.torch_threads import few_torch_threads  # noqa: F401


def _model_action(parser):
    return next(a for a in parser._actions if a.dest == "model")


@pytest.mark.parametrize("cli", [train_cli, evaluate_cli, predict_cli],
                         ids=["train", "evaluate", "predict"])
def test_model_choices_are_the_table_keys(cli):
    action = _model_action(cli.build_parser())
    assert list(action.choices) == list(FAMILIES)
    assert action.default == DEFAULT == "graphmet"


@pytest.mark.parametrize("name", list(FAMILIES))
def test_fit_finds_each_row_from_its_model(name):
    fam = FAMILIES[name]
    model = fam.build(Config(), generator=torch.Generator().manual_seed(0))
    assert isinstance(model, fam.model)
    assert of_model(model) is fam is family(name)


def test_unknown_names_and_models_are_refused():
    with pytest.raises(ValueError, match="unknown model family"):
        family("gnn")
    with pytest.raises(ValueError, match="has no mesh step"):
        mesh_forms("particlenet")
    with pytest.raises(ValueError, match="no model family"):
        of_model(torch.nn.Linear(2, 2))


def test_run_config_grafts_every_family_section(tmp_path):
    """``load_run_config`` takes each row's section from the run's file and
    the defaults for the rest."""
    base = Config()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, compute_dtype="bfloat16"),
        drn=dataclasses.replace(base.drn, output_scale=7.0),
        particlenet=dataclasses.replace(base.particlenet, output_scale=8.0),
        data=dataclasses.replace(base.data, batch_size=3))
    (tmp_path / "config.json").write_text(cfg.to_json())
    run = load_run_config(str(tmp_path))
    assert Config.from_json(cfg.to_json()) == cfg
    assert run == dataclasses.replace(cfg, data=base.data)
    assert {f.section for f in FAMILIES.values()} == {
        "model", "drn", "particlenet"}


# ------------------------------------------------- the benchmark's hooks


def _events():
    t = traffic(events=2, batch=2)
    t["candidates"] = dict(t["candidates"], min=60, max=240)
    return gen.make_events(t, 5)


def _setup(name):
    fam = FAMILIES[name]
    model = fam.build(Config(), generator=torch.Generator().manual_seed(1))
    return fam, model, to_device(collate(_events(), (128, 256)), "cpu")


def _objective(name):
    """A call of the family's objective, made once."""
    fam, model, batch = _setup(name)
    objective = fam.objective(Config())

    def run():
        torch.manual_seed(0)                  # ParticleNet's dropout masks
        model.train()
        return objective(model, batch).detach()

    return run


def _eval(name):
    """A call of the family's eval step, made once."""
    fam, model, batch = _setup(name)
    step = fam.eval_step(Config())
    return lambda: step(model, batch)[0]


def _drn_k2(orig):
    return lambda h, mask, *a, **kw: orig(h, mask, *a, **{**kw, "k": 2})


def _unmatched(orig):
    def cut(g, h, mask, *a, **kw):
        iota = torch.arange(mask.shape[1]).expand(mask.shape)
        return iota.clone(), iota.clone()

    return cut


def _plus_one(orig):
    return lambda *a, **kw: orig(*a, **kw) + 1.0


def _doubled(orig):
    return lambda *a, **kw: 2.0 * orig(*a, **kw)


HOOKS = [
    ("train.step", "loss_fn", "graphmet", _objective, _plus_one),
    ("train.step", "_neg_weighted_met", "graphmet", _eval, _doubled),
    ("train.step", "drn_loss_fn", "drn", _objective, _plus_one),
    ("train.step", "drn_loss_fn", "particlenet", _objective, _plus_one),
    ("train.step", "drn_met_vector", "drn", _eval, _doubled),
    ("train.step", "drn_met_vector", "particlenet", _eval, _doubled),
    ("train.loss", "drn_met_vector", "drn", _objective, _doubled),
    ("models.drn", "build_dyn_graph", "drn", _eval, _drn_k2),
    ("models.drn", "cut_matching", "drn", _eval, _unmatched),
    ("models.particlenet", "particlenet_apply", "particlenet", _eval,
     _doubled),
    ("models.particlenet", "apply_dropout", "particlenet", _objective,
     lambda orig: lambda h, keep, p: h),
]


@pytest.mark.parametrize("module,name,fam,run,patch", HOOKS,
                         ids=[f"{m}.{n}-{f}" for m, n, f, _, _ in HOOKS])
def test_patching_a_hooked_name_changes_the_step(monkeypatch, module, name,
                                                 fam, run, patch):
    mod = importlib.import_module(f"deepmetv2_tpu_torch.{module}")
    step = run(fam)                     # made before the patch, as the
    plain = step()                      # benchmark makes its steps
    assert torch.isfinite(plain).all()
    monkeypatch.setattr(mod, name, patch(getattr(mod, name)))
    assert not torch.equal(step(), plain)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_chained_step_is_called_through_its_class(monkeypatch, name):
    """``faults.not_captured`` replaces ``ChainedStep.__call__`` on the
    class: each family's chained step must be one."""
    _, model, _ = _setup(name)
    step = tchain.make_chained_train_step(Config(), name)
    seen = []
    call = tchain.ChainedStep.__call__

    def spy(self, *a):
        seen.append(self)
        return call(self, *a)

    monkeypatch.setattr(tchain.ChainedStep, "__call__", spy)
    stacked = to_device(tchain.stack_batches(
        [collate(_events(), (128, 256))]), "cpu")
    losses = step(model, make_optimizer(Config(), model), stacked)
    assert seen == [step] and losses.shape == (1,)
