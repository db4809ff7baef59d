"""Weights made from the seed, on the device, in a few large calls.

The benchmark makes every parameter and BatchNorm buffer itself and hands
the same tensors to the port (``load_state_dict``) and to the plain
reference (a dict by the same names): neither side derives weights from
the other.  Linear layers are uniform in +-1/sqrt(fan_in) (torch's default
bound), embeddings N(0, 1), BatchNorm gamma 1 and beta 0, running means
N(0, 0.1^2) and running variances uniform in [0.5, 1.5] (so that an
evaluation step's BatchNorm is not the identity).  Names and the ``[in,
out]`` layout of a linear weight are the port's state_dict keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def _linear(spec: Spec, name: str, fan_in: int, fan_out: int) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    spec.append((f"{name}.w", (fan_in, fan_out), "uniform", bound))
    spec.append((f"{name}.b", (fan_out,), "uniform", bound))


def _bn(spec: Spec, name: str, dim: int) -> None:
    spec += [(f"{name}.gamma", (dim,), "one", 0.0),
             (f"{name}.beta", (dim,), "zero", 0.0),
             (f"{name}.running_mean", (dim,), "normal", 0.1),
             (f"{name}.running_var", (dim,), "var", 0.0),
             (f"{name}.num_batches_tracked", (), "count", 0.0)]


def graphmet_spec(model: dict) -> Spec:
    """GraphMETNetwork's leaves for the config's ``model`` section."""
    H, spec = int(model["hidden_dim"]), []
    for name, vocab in (("embed_charge", 3), ("embed_pdgid", 7),
                        ("embed_pv", 8)):
        spec.append((f"{name}.w", (vocab, H // 4), "normal", 1.0))
    _linear(spec, "embed_continuous", int(model["continuous_dim"]), H // 2)
    _linear(spec, "embed_categorical", 3 * H // 4, H // 2)
    _linear(spec, "encode_all", H, H)
    _bn(spec, "bn_all", H)
    for d in range(int(model["conv_depth"])):
        _linear(spec, f"convs.{d}.edge", 2 * H, H)
        _bn(spec, f"convs.{d}.bn", H)
    _linear(spec, "output.layers.0", H, H // 2)
    _linear(spec, "output.layers.1", H // 2, int(model["output_dim"]))
    return spec


def drn_spec(drn: dict) -> Spec:
    """The DynamicReductionNetwork's leaves for the config's ``drn``
    section; ``datanorm`` is given by the caller."""
    H, F = int(drn["hidden_dim"]), int(drn["input_dim"])
    spec: Spec = [("datanorm", (F,), "given", 0.0)]
    for i, (a, b) in enumerate(((F, H // 2), (H // 2, H), (H, H))):
        _linear(spec, f"inputnet.layers.{i}", a, b)
    for i, (a, b) in enumerate(((H, H), (H, H // 2),
                                (H // 2, int(drn["output_dim"])))):
        _linear(spec, f"output.layers.{i}", a, b)
    for r in range(int(drn["pool_rounds"])):
        _linear(spec, f"convs.{r}.mlp.layers.0", 2 * H, 3 * H // 2)
        _linear(spec, f"convs.{r}.mlp.layers.1", 3 * H // 2, H)
        _bn(spec, f"convs.{r}.bn", H)
    return spec


def drn_datanorm(events) -> list:
    """The DRN's input scale: 1/std of each feature over the events'
    candidates (1 where the std is under 1e-6), as the train CLI derives
    it (``cli/train.py:drn_data_init``)."""
    x = np.concatenate([e[0] for e in events]).astype(np.float64)
    std = x.std(axis=0)
    return list(1.0 / np.where(std > 1e-6, std, 1.0))


def make(spec: Spec, seed: int, device,
         given: Optional[Dict[str, Sequence[float]]] = None
         ) -> Dict[str, torch.Tensor]:
    """The leaves of ``spec`` from ``seed`` on ``device``: one uniform, one
    normal draw for all leaves of each kind, then split and scaled."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in spec if k == kind)
             for kind in ("uniform", "normal", "var")}
    pools = {
        "uniform": torch.rand(sizes["uniform"], generator=gen,
                              device=device) * 2 - 1,
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
        "var": torch.rand(sizes["var"], generator=gen, device=device) + 0.5,
    }
    used = dict.fromkeys(pools, 0)
    out = {}
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind in pools:
            t = pools[kind][used[kind]:used[kind] + n].reshape(shape)
            used[kind] += n
            out[name] = t * scale if kind != "var" else t.clone()
        elif kind == "given":
            out[name] = torch.tensor(list(given[name]), dtype=torch.float32,
                                     device=device).reshape(shape)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0,
                                   device=device)
    return out


def clone(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in leaves.items()}
