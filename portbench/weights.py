"""Weights made from the seed, on the device, in a few large calls.

The benchmark makes every parameter and BatchNorm buffer itself and hands
the same tensors to the port (``load_state_dict``) and to the plain
reference (a dict by the same names): neither side derives weights from
the other.  Each family file (``families/``) lists its leaves with
``linear`` and ``bn``; ``make`` draws them.  Linear layers are uniform in
+-1/sqrt(fan_in) (torch's default bound), embeddings N(0, 1), BatchNorm
gamma 1 and beta 0, running means N(0, 0.1^2) and running variances
uniform in [0.5, 1.5] (so that an evaluation step's BatchNorm is not the
identity).  Names and the ``[in, out]`` layout of a linear weight are the
port's state_dict keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def linear(spec: Spec, name: str, fan_in: int, fan_out: int) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    spec.append((f"{name}.w", (fan_in, fan_out), "uniform", bound))
    spec.append((f"{name}.b", (fan_out,), "uniform", bound))


def bn(spec: Spec, name: str, dim: int) -> None:
    spec += [(f"{name}.gamma", (dim,), "one", 0.0),
             (f"{name}.beta", (dim,), "zero", 0.0),
             (f"{name}.running_mean", (dim,), "normal", 0.1),
             (f"{name}.running_var", (dim,), "var", 0.0),
             (f"{name}.num_batches_tracked", (), "count", 0.0)]


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
