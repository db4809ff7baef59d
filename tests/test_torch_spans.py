"""The port's spans (utils/profiling.py): off outside a trace, and inside
``profiling.trace`` the registry's names where the work happens, nested
as the layers are, on the CPU at tiny sizes."""

import ast
import glob
import json
import os.path as osp

import pytest
import torch

from deepmetv2_tpu_torch.config import (Config, DRNConfig, GraphConfig,
                                        TrainConfig)
from deepmetv2_tpu_torch.data import collate, fetch_dataloader, to_device
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.models.drn import DRN
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.train import step as tstep
from deepmetv2_tpu_torch.train.chain import make_chained_train_step
from deepmetv2_tpu_torch.train.loop import train_one_epoch
from deepmetv2_tpu_torch.train.resident import ResidentFeed
from deepmetv2_tpu_torch.utils import profiling
from tests.torch_threads import few_torch_threads  # noqa: F401

PORT = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                "deepmetv2_tpu_torch")


def annotate_calls():
    """``(path:line, name)`` of every ``annotate(...)`` call in the port;
    the name None where it is not one string literal."""
    calls = []
    for path in sorted(glob.glob(osp.join(PORT, "**", "*.py"),
                                 recursive=True)):
        for node in ast.walk(ast.parse(open(path).read())):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if fname != "annotate":
                continue
            arg = node.args[0] if len(node.args) == 1 else None
            name = (arg.value if isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) else None)
            calls.append((f"{osp.relpath(path, PORT)}:{node.lineno}", name))
    return calls


def test_every_span_is_a_registry_entry_and_every_entry_is_used():
    calls = annotate_calls()
    bad = [where for where, name in calls if name not in profiling.SPANS]
    assert not bad, f"annotate names outside SPANS at {bad}"
    unused = set(profiling.SPANS) - {name for _, name in calls}
    assert not unused, f"SPANS entries no annotate uses: {sorted(unused)}"


def test_annotate_off_is_the_shared_null_context():
    """Outside a trace ``annotate`` hands out one shared null context and
    leaves nothing in a profile taken around it; ``spans_on`` turns the
    spans on for its region only."""
    off = profiling.annotate("step.eval")
    assert off is profiling.annotate("graph.knn") is profiling._NULL
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.annotate("step.eval"):
            torch.ones(8) + 1
    names = {e.name for e in prof.events()}
    assert "aten::add" in names and "step.eval" not in names
    with profiling.spans_on():
        with profiling.spans_on():
            pass
        assert profiling.annotate("step.eval") is not profiling._NULL
    assert profiling.annotate("step.eval") is profiling._NULL


def traced_spans(tmp_path, body):
    """The registry's spans that ``body()`` leaves in a ``profiling.trace``
    of it: ``(name, parent)`` per span, the parent being the innermost
    registry span of the same thread that holds it (None at the top)."""
    with profiling.trace(str(tmp_path / "tr")):
        body()
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) +
              float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") in profiling.SPANS]
    out = []
    for name, tid, s, e in spans:
        around = [(e2 - s2, n2) for n2, t2, s2, e2 in spans
                  if t2 == tid and s2 <= s and e <= e2
                  and (s2, e2) != (s, e)]
        out.append((name, min(around)[1] if around else None))
    return out


def _events(n, n_max):
    return synthetic_events(n, seed=11, n_min=20, n_max=n_max)


def graphmet_eval():
    cfg = Config(graph=GraphConfig(mode="window", window_halo=64))
    model, step = GraphMET(cfg.model), tstep.make_eval_step(cfg)

    def body():
        batch = to_device(collate(_events(4, 60), buckets=(64,)), "cpu")
        step(model, batch)

    return body, {"step.eval": {"graph.sort", "model.embed", "model.conv",
                                "model.head", "graph.unsort"}}


def drn_eval():
    cfg = Config(drn=DRNConfig(hidden_dim=16, k=4, head="cartesian"))
    model, step = DRN(cfg.drn), tstep.make_drn_eval_step(cfg)

    def body():
        batch = to_device(collate(_events(4, 120), buckets=(128,)), "cpu")
        step(model, batch)

    return body, {"step.eval": {"model.embed", "graph.knn", "model.conv",
                                "graph.match", "graph.pool", "model.head"}}


def graphmet_train_epoch():
    cfg = Config(graph=GraphConfig(mode="window", window_halo=64),
                 train=TrainConfig(chain_steps=2))
    model = GraphMET(cfg.model)
    opt = tstep.make_optimizer(cfg, model)
    step = make_chained_train_step(cfg, "graphmet")
    loader = fetch_dataloader(events=_events(20, 60), batch_size=4,
                              buckets=(64,))["train"]

    def body():
        feed = ResidentFeed(loader, chain=2, place="cpu")
        train_one_epoch(model, opt, step, feed, 0, "cpu", verbose=False)

    return body, {"feed.stage": {"data.collate", "data.to_device"},
                  "step.train": {"graph.sort", "model.embed", "model.conv",
                                 "model.head"}}


@pytest.mark.parametrize("case", [graphmet_eval, drn_eval,
                                  graphmet_train_epoch])
def test_a_trace_holds_the_layer_spans_nested(case, tmp_path):
    """Each span lies inside the layer that calls it: the graph and model
    spans inside the step, the host data's outside it."""
    body, children = case()
    spans = traced_spans(tmp_path, body)
    got = {}
    for name, parent in spans:
        got.setdefault(parent, set()).add(name)
    for parent, names in children.items():
        assert got.get(parent) == names, (parent, got)
    tops = got[None]
    assert set(children) <= tops
    assert "data.to_device" in (tops if "step.eval" in children
                                else got["feed.stage"])
    steps = 1
    if case is graphmet_train_epoch:        # 16 training events, batch 4
        assert tops == {"feed.stage", "step.train", "train.epoch_end"}
        steps = sum(n == "step.train" for n, _ in spans)
        assert steps == 4
    else:
        assert tops == {"data.collate", "data.to_device", "step.eval"}
    assert sum(n == "model.conv" for n, _ in spans) == 2 * steps
