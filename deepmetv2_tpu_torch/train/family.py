"""The port's model families, one row each, keyed by the ``--model``
name: what the CLIs, ``fit`` and the chained and mesh steps need of a
family.  Callers look a family up here instead of branching on it, so a
new family is its ``models/`` file, its ``Config`` section and a row.
Neither ``models/`` nor ``ops/`` imports this table; the mesh forms
(``parallel/``) are imported at their first call."""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, Optional

import numpy as np

from deepmetv2_tpu_torch.models.drn import DRN
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.models.particlenet import (ParticleNet,
                                                    particlenet_net_apply)
from deepmetv2_tpu_torch.train.step import (drn_objective, eval_step_terms,
                                            graphmet_objective,
                                            make_drn_eval_step,
                                            make_eval_step,
                                            particlenet_objective)


def _lazy(module: str, name: str) -> Callable:
    """``deepmetv2_tpu_torch.<module>.<name>``, looked up at each call."""
    def call(*args):
        return getattr(importlib.import_module(
            f"deepmetv2_tpu_torch.{module}"), name)(*args)

    return call


@dataclasses.dataclass(frozen=True)
class MeshForms:
    """A family's steps on a mesh (parallel/)."""

    dp_objective: Callable   # (cfg, mesh) -> (model, batch) -> (share, share)
    dp_eval_terms: Callable  # cfg -> (model, batch) -> (v_met, total, n, w)
    node_step: Callable      # (cfg, mesh) -> its step, nodes split N ways
    node_form: Callable      # cfg -> that step, as the "mesh:" line names it
    ring_knn: bool = False   # that step takes --ring_knn


@dataclasses.dataclass(frozen=True)
class Family:
    """One family's row."""

    name: str
    model: type              # its class in models/, built from its section
    section: str             # its Config section
    init: Callable           # (cfg, train loader, generator, say) ->
    #                          (cfg, model) of a new run
    objective: Callable      # cfg -> (model, batch) -> loss
    eval_step: Callable      # cfg -> (model, batch) -> (v_met, loss, w)
    # its graph is --graph_mode's (eta, phi) radius graph: its loaders
    # presort in window mode, and its node-split mesh step needs that mode
    presorts: bool = False
    from_torch: bool = False     # warm-starts from a reference .pth.tar
    mesh: Optional[MeshForms] = None       # None: trains on one device

    def build(self, cfg, **kw):
        """The model of ``cfg``'s section (``kw``: ``device``,
        ``generator``)."""
        return self.model(getattr(cfg, self.section), **kw)


def drn_data_init(dataset, indices):
    """``(norm, met_bias)`` from the training split, as the JAX CLI derives
    them (cli/train.py:246-277): ``norm`` 1/std of each input feature over
    every training candidate (one streaming float64 pass; 1 where the std
    is below 1e-6), ``met_bias`` the mean |genMET| of the training events
    (0 for an empty split)."""
    qts = [float(np.hypot(dataset[int(i)][1][0], dataset[int(i)][1][1]))
           for i in indices]
    met_bias = float(np.mean(qts)) if qts else 0.0
    n_feat = dataset[int(indices[0])][0].shape[1]
    cnt, s1, s2 = 0, np.zeros(n_feat), np.zeros(n_feat)
    for i in indices:
        x = dataset[int(i)][0]
        cnt += x.shape[0]
        s1 += x.sum(axis=0)
        s2 += (x.astype(np.float64) ** 2).sum(axis=0)
    var = np.maximum(s2 / cnt - (s1 / cnt) ** 2, 0.0)
    std = np.sqrt(var)
    return tuple(1.0 / np.where(std > 1e-6, std, 1.0)), met_bias


def _graphmet_init(cfg, train, generator, say):
    return cfg, GraphMET(cfg.model, generator=generator)


def _drn_init(cfg, train, generator, say):
    """``datanorm`` and the output scale from the training split, as the
    JAX CLI sets them."""
    if cfg.drn.head == "polar":
        # the JAX CLI's warning (cli/train.py:181-189): on its 150-epoch
        # synthetic run the softplus MET went to 0 and the sigmoid phi to
        # pi within one epoch, and training froze
        say("warning: the polar DRN head saturates easily and can freeze "
            "training (softplus MET -> 0, sigmoid phi -> pi); "
            "--drn_head cartesian is the robust choice")
    norm, met_bias = drn_data_init(train.dataset, train.indices)
    if met_bias > 0:
        cfg = dataclasses.replace(
            cfg, drn=dataclasses.replace(cfg.drn, output_scale=met_bias))
    say(f"drn: output scale = mean |genMET| = {met_bias:.1f}; "
        f"datanorm from training-set feature stds")
    return cfg, DRN(cfg.drn, generator=generator, norm=norm, met_bias=met_bias)


def _particlenet_init(cfg, train, generator, say):
    _, met_bias = drn_data_init(train.dataset, train.indices)
    if met_bias > 0:
        cfg = dataclasses.replace(cfg, particlenet=dataclasses.replace(
            cfg.particlenet, output_scale=met_bias))
    say(f"particlenet: output scale = mean |genMET| = {met_bias:.1f}")
    return cfg, ParticleNet(cfg.particlenet, generator=generator)


DEFAULT = "graphmet"

FAMILIES: Dict[str, Family] = {f.name: f for f in (
    Family("graphmet", GraphMET, "model", _graphmet_init, graphmet_objective,
           make_eval_step, presorts=True, from_torch=True,
           mesh=MeshForms(_lazy("parallel.dp", "graphmet_dp_objective"),
                          eval_step_terms,
                          _lazy("parallel.ep", "make_ep_train_step"),
                          lambda cfg: "edge-partitioned")),
    Family("drn", DRN, "drn", _drn_init, drn_objective, make_drn_eval_step,
           mesh=MeshForms(_lazy("parallel.dp", "drn_dp_objective"),
                          _lazy("parallel.dp", "drn_dp_eval_terms"),
                          _lazy("parallel.dyn", "make_drn_ep_train_step"),
                          lambda cfg: "node-sharded DRN, " + (
                              "ring" if cfg.drn.ring_knn else "all-gather")
                          + " kNN", ring_knn=True)),
    Family("particlenet", ParticleNet, "particlenet", _particlenet_init,
           particlenet_objective,
           functools.partial(make_drn_eval_step, apply=particlenet_net_apply,
                             head="cartesian")),
)}


def family(name: str) -> Family:
    """``FAMILIES[name]``, a ValueError for a name it lacks."""
    if name not in FAMILIES:
        raise ValueError(f"unknown model family {name!r}")
    return FAMILIES[name]


def mesh_forms(name: str) -> MeshForms:
    """The mesh forms of ``name``, a ValueError for a family without."""
    forms = family(name).mesh
    if forms is None:
        raise ValueError(f"model family {name!r} has no mesh step")
    return forms


def of_model(model) -> Family:
    """The row whose class ``model`` is an instance of."""
    for fam in FAMILIES.values():
        if isinstance(model, fam.model):
            return fam
    raise ValueError(f"no model family has the class {type(model).__name__}")
