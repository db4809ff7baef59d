"""The JAX package's pytree layout of a model's parameters, BatchNorm state
and AdamW state, shared by both model families.

A model lists ``(JAX pytree path, tensor)`` for every parameter and
BatchNorm buffer in ``jax_layout``; ``JaxLayout`` turns that list into the
conversions a checkpoint of either package needs: parameters and
BatchNorm state in (``params_from_jax``) and out (``params_to_jax``), and
the AdamW moments in and out (``optimizer_state_from_jax``,
``optimizer_state_to_jax``), optax's ``ScaleByAdamState`` against
``torch.optim.AdamW``'s state.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from deepmetv2_tpu_torch.nn.core import BatchNormState


class JaxLayout(nn.Module):
    """Base of the models: the conversions to and from the JAX package's
    trees, driven by the subclass's ``jax_layout``."""

    def jax_layout(self) -> Iterator[Tuple[Tuple[Any, ...], torch.Tensor]]:
        """(JAX pytree path, tensor) for every parameter and BatchNorm
        buffer: paths into the JAX ``params`` start with 'params', paths
        into its ``bn_state`` with 'bn_state' and end with the
        ``BatchNormState`` field's index (0 mean, 1 var, 2 count)."""
        raise NotImplementedError

    @torch.no_grad()
    def params_from_jax(self, params: Dict, bn_state: Dict):
        """Copy JAX parameters and BatchNorm state (numpy leaves, as a JAX
        checkpoint or the JAX package's init holds them) into this
        module."""
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
        int32 and each state a ``BatchNormState``, as the JAX package keeps
        them)."""
        items, states = [], set()
        for path, t in self.jax_layout():
            v = t.detach().cpu().numpy().copy()
            if path[0] == "bn_state":
                states.add(path[:-1])
                if path[-1] == 2:
                    v = v.astype(np.int32)
            items.append((path, v))
        trees = _nest(items)
        for prefix in sorted(states, key=len, reverse=True):
            parent = trees
            for k in prefix[:-1]:
                parent = parent[k]
            parent[prefix[-1]] = BatchNormState(*parent[prefix[-1]])
        return trees["params"], trees["bn_state"]

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
        package's state or the port's own (``optimizer_state_to_jax``).

        A capturable optimizer (train/step.py:make_optimizer) keeps its
        form: the step counts land on the parameters' device, and a tensor
        lr stays the same tensor, with the restored value written into it
        (``load_state_dict`` alone would put a copy in its place, and a
        captured graph would go on reading the old one)."""
        count, lr, mu, nu = _adam_state(opt_state)
        sd = optimizer.state_dict()
        index = {id(p): i for i, p in enumerate(
            p for g in optimizer.param_groups for p in g["params"])}
        lr_tensors = [g["lr"] for g in optimizer.param_groups]
        on_device = {id(p): g["capturable"] for g in optimizer.param_groups
                     for p in g["params"]}
        state = {}
        for path, t in self._param_paths():
            state[index[id(t)]] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=t.device if on_device[id(t)]
                                     else "cpu"),
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
        for g, t in zip(optimizer.param_groups, lr_tensors):
            if isinstance(t, torch.Tensor):
                t.fill_(lr)
                g["lr"] = t

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
