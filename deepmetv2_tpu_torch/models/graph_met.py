"""GraphMETNetwork — the per-candidate weight regressor (the JAX package's
``models/graph_met.py``; reference model/graph_met_network.py:11-69 and the
``Net`` sigmoid wrapper, model/net.py:38-47):

* embeddings of charge [3, H/4], |pdgId| [7, H/4], fromPV [8, H/4];
* continuous encoder Linear(8→H/2)+ELU, categorical encoder
  Linear(3H/4→H/2)+ELU, joint encoder Linear(H→H)+ELU, masked BatchNorm;
* ``conv_depth`` residual blocks ``emb += BN(EdgeConv_linear(emb))``;
* head Linear(H→H/2)+ELU+Linear(H/2→1), sigmoid → w ∈ (0, 1).

Parameters keep the JAX package's names and ``[in, out]`` layout, so
``params_from_jax`` carries a JAX checkpoint across unchanged and
``params_to_jax`` writes the same trees back; ``optimizer_state_from_jax``
and ``optimizer_state_to_jax`` do the same for the AdamW moments.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deepmetv2_tpu_torch.config import ModelConfig
from deepmetv2_tpu_torch.data.batching import EventBatch
from deepmetv2_tpu_torch.nn.core import (MLP, BatchNormState, Embedding,
                                         Linear, MaskedBatchNorm, elu)
from deepmetv2_tpu_torch.ops.edgeconv import edgeconv


def pdg_remap(pdg: torch.Tensor, pdgs=(1, 2, 11, 13, 22, 130, 211)
              ) -> torch.Tensor:
    """|pdgId| ∈ {1,2,11,13,22,130,211} → {0..6}; unknown ids (padding
    zeros included) → 0."""
    table = torch.as_tensor(pdgs, dtype=pdg.dtype, device=pdg.device)
    matches = pdg.abs()[..., None] == table
    return torch.argmax(matches.to(torch.int8), dim=-1)


class EdgeConvBlock(nn.Module):
    def __init__(self, H: int, generator=None, device=None):
        super().__init__()
        self.edge = Linear(2 * H, H, generator, device)
        self.bn = MaskedBatchNorm(H, device)


class GraphMET(nn.Module):
    """The JAX package's ``graph_met_init`` is the constructor (torch's
    default initialization from ``generator``) and its ``graph_met_apply``
    is ``forward``: raw (pre-sigmoid) scores ``[B, N]``, garbage at padded
    nodes; ``net_apply`` turns them into weights.  Training mode uses batch
    statistics in BatchNorm and updates its buffers."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r} is not ported yet "
                "(ROADMAP A9); use float32")
        self.cfg = cfg
        H = cfg.hidden_dim
        g, d = generator, device
        self.embed_charge = Embedding(3, H // 4, g, d)
        self.embed_pdgid = Embedding(7, H // 4, g, d)
        self.embed_pv = Embedding(8, H // 4, g, d)
        self.embed_continuous = Linear(cfg.continuous_dim, H // 2, g, d)
        self.embed_categorical = Linear(3 * H // 4, H // 2, g, d)
        self.encode_all = Linear(H, H, g, d)
        self.bn_all = MaskedBatchNorm(H, d)
        self.convs = nn.ModuleList(EdgeConvBlock(H, g, d)
                                   for _ in range(cfg.conv_depth))
        self.output = MLP((H, H // 2, cfg.output_dim), g, d)

    def forward(self, batch: EventBatch, graph) -> torch.Tensor:
        x_cat = batch.x_cat
        emb_cont = elu(self.embed_continuous(batch.x_cont))
        emb_chrg = self.embed_charge(torch.clamp(x_cat[..., 1] + 1, 0, 2))
        emb_pv = self.embed_pv(torch.clamp(x_cat[..., 2], 0, 7))
        emb_pdg = self.embed_pdgid(pdg_remap(x_cat[..., 0], self.cfg.pdgs))
        emb_cat = elu(self.embed_categorical(
            torch.cat([emb_chrg, emb_pdg, emb_pv], dim=-1)))
        enc = elu(self.encode_all(torch.cat([emb_cat, emb_cont], dim=-1)))
        emb = self.bn_all(enc, batch.mask)
        for conv in self.convs:
            h = edgeconv(emb, graph, conv.edge.w, conv.edge.b, "max")
            emb = emb + conv.bn(h, batch.mask)  # residual
        return self.output(emb).squeeze(-1)

    def jax_layout(self) -> Iterator[Tuple[Tuple[Any, ...], torch.Tensor]]:
        """(JAX pytree path, tensor) for every parameter and BatchNorm
        buffer: paths into the JAX ``params`` start with 'params', paths
        into its ``bn_state`` with 'bn_state'."""
        for name in ("embed_charge", "embed_pdgid", "embed_pv"):
            yield ("params", name, "w"), getattr(self, name).w
        for name in ("embed_continuous", "embed_categorical", "encode_all"):
            lin = getattr(self, name)
            yield ("params", name, "w"), lin.w
            yield ("params", name, "b"), lin.b
        for i, lin in enumerate(self.output.layers):
            yield ("params", "output", f"lin{i}", "w"), lin.w
            yield ("params", "output", f"lin{i}", "b"), lin.b
        bns = [(("bn_all",), self.bn_all)] + [
            (("convs", d), conv.bn) for d, conv in enumerate(self.convs)]
        for d, conv in enumerate(self.convs):
            yield ("params", "convs", d, "edge", "w"), conv.edge.w
            yield ("params", "convs", d, "edge", "b"), conv.edge.b
        for path, bn in bns:
            p = ("params",) + path + ("bn",) * (path[0] == "convs")
            yield p + ("gamma",), bn.gamma
            yield p + ("beta",), bn.beta
            yield ("bn_state",) + path + (0,), bn.running_mean
            yield ("bn_state",) + path + (1,), bn.running_var
            yield ("bn_state",) + path + (2,), bn.num_batches_tracked

    @torch.no_grad()
    def params_from_jax(self, params: Dict, bn_state: Dict) -> "GraphMET":
        """Copy JAX parameters and BatchNorm state (numpy arrays, as a JAX
        checkpoint or ``graph_met_init`` holds them) into this module."""
        trees = {"params": params, "bn_state": bn_state}
        for path, t in self.jax_layout():
            v = _leaf(trees, path)
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{path}: shape {v.shape} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(v).to(t.dtype))
        return self

    @torch.no_grad()
    def params_to_jax(self) -> Tuple[Dict, Dict]:
        """``(params, bn_state)`` as numpy trees in the JAX package's
        layout, the inverse of ``params_from_jax`` (BatchNorm counts as
        int32, as the JAX package keeps them)."""
        items = []
        for path, t in self.jax_layout():
            v = t.detach().cpu().numpy().copy()
            items.append((path, v.astype(np.int32) if path[0] == "bn_state"
                          and path[-1] == 2 else v))
        trees = _nest(items)
        bn = trees["bn_state"]
        bn["bn_all"] = BatchNormState(*bn["bn_all"])
        bn["convs"] = [BatchNormState(*s) for s in bn["convs"]]
        return trees["params"], bn

    def _param_paths(self):
        return [(path[1:], t) for path, t in self.jax_layout()
                if path[0] == "params"]

    @torch.no_grad()
    def optimizer_state_from_jax(self, opt_state,
                                 optimizer: torch.optim.Optimizer) -> None:
        """Load an AdamW state into ``optimizer`` (a ``torch.optim.AdamW``
        over this model's parameters): optax's ``ScaleByAdamState``
        ``mu``/``nu``/``count`` become ``exp_avg``/``exp_avg_sq``/``step``
        and the injected learning rate the groups' lr.  Takes the JAX
        package's state or the port's own (``optimizer_state_to_jax``)."""
        count, lr, mu, nu = _adam_state(opt_state)
        sd = optimizer.state_dict()
        index = {id(p): i for i, p in enumerate(
            p for g in optimizer.param_groups for p in g["params"])}
        state = {}
        for path, t in self._param_paths():
            state[index[id(t)]] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.from_numpy(_leaf(mu, path)).to(t),
                "exp_avg_sq": torch.from_numpy(_leaf(nu, path)).to(t),
            }
        if len(state) != len(index):
            raise ValueError(f"optimizer holds {len(index)} tensors, the "
                             f"model's layout {len(state)}")
        sd["state"] = state
        for g in sd["param_groups"]:
            g["lr"] = lr
        optimizer.load_state_dict(sd)

    @torch.no_grad()
    def optimizer_state_to_jax(self, optimizer: torch.optim.Optimizer) -> Dict:
        """The port's own optimizer state, the inverse of
        ``optimizer_state_from_jax``: ``{"optimizer": "AdamW", "count",
        "lr", "mu", "nu"}`` with the moments as numpy trees in the JAX
        layout of ``params`` (zeros before the first step)."""
        def moment(t, key):
            st = optimizer.state.get(t, {})
            v = st.get(key, torch.zeros_like(t))
            return v.detach().cpu().numpy().copy()

        paths = self._param_paths()
        st = optimizer.state.get(paths[0][1], {})
        count = int(st["step"]) if "step" in st else 0
        return {"optimizer": "AdamW", "count": count,
                "lr": float(optimizer.param_groups[0]["lr"]),
                "mu": _nest([(p, moment(t, "exp_avg")) for p, t in paths]),
                "nu": _nest([(p, moment(t, "exp_avg_sq")) for p, t in paths])}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.array(tree)


def _nest(items) -> Dict:
    """``[(path, value)]`` → nested containers: dicts, with every dict whose
    keys are 0..n-1 turned into a list (the JAX pytree layout)."""
    root: Dict = {}
    for path, v in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    return fix(root)


def _adam_state(opt_state):
    """``(count, lr, mu, nu)`` from either package's optimizer state: the
    port's own dict, or optax's ``inject_hyperparams(adamw)`` state, alone
    or as the element of a ``chain`` after ``clip_by_global_norm``."""
    if isinstance(opt_state, dict):
        return (int(opt_state["count"]), float(opt_state["lr"]),
                opt_state["mu"], opt_state["nu"])
    elems = (opt_state,) if hasattr(opt_state, "hyperparams") else opt_state
    for el in elems:
        if hasattr(el, "hyperparams"):
            adam = el.inner_state[0]          # ScaleByAdamState
            return (int(adam.count), float(el.hyperparams["learning_rate"]),
                    adam.mu, adam.nu)
    raise ValueError(f"no AdamW state in {type(opt_state).__name__}")


def net_apply(model: GraphMET, batch: EventBatch, graph) -> torch.Tensor:
    """``Net``: sigmoid weights in (0, 1), zero at padded slots
    (reference model/net.py:45-47)."""
    w = torch.sigmoid(model(batch, graph))
    return torch.where(batch.mask, w, torch.zeros_like(w))
