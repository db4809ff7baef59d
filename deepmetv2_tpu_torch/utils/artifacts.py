"""Artifact persistence: lz4-frame pickles (reference utils.py:32-57).

``save`` writes a pickle of protocol 5 inside an lz4 frame: the bytes the
JAX package's ``artifacts.save`` writes (its cloudpickle defaults to
protocol 5 and pickles importable objects as ``pickle`` does).  ``load``
reads artifacts of either package, including JAX checkpoints: their
pickles name classes of the JAX package and of optax, which are mapped
here to plain named tuples instead of being imported.
"""

from __future__ import annotations

import collections
import io
import json
import pickle
from typing import Any, Dict

from deepmetv2_tpu_torch.nn.core import BatchNormState
from deepmetv2_tpu_torch.utils import lz4f

# Containers standing in for the classes a JAX checkpoint pickles.  Each is
# rebuilt by NEWOBJ as cls(*fields), so a namedtuple of the same fields fits.
ScaleByAdamState = collections.namedtuple("ScaleByAdamState",
                                          ["count", "mu", "nu"])
InjectStatefulHyperparamsState = collections.namedtuple(
    "InjectStatefulHyperparamsState",
    ["count", "hyperparams", "hyperparams_states", "inner_state"])
EmptyState = collections.namedtuple("EmptyState", [])

_FOREIGN = {
    ("deepmetv2_tpu.nn.core", "BatchNormState"): BatchNormState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax.schedules._inject", "InjectStatefulHyperparamsState"):
        InjectStatefulHyperparamsState,
    ("optax._src.base", "EmptyState"): EmptyState,
}


class _Unpickler(pickle.Unpickler):
    """Maps JAX-package and optax classes to plain containers, and numpy's
    module paths across the 1.x (``numpy.core``) / 2.x (``numpy._core``)
    rename in both directions."""

    def find_class(self, module: str, name: str):
        if (module, name) in _FOREIGN:
            return _FOREIGN[(module, name)]
        head, _, tail = module.partition(".core")
        if head == "numpy" and tail[:1] in ("", "."):       # numpy.core[.x]
            candidates = ["numpy._core" + tail, module]
        elif module.split(".")[:2] == ["numpy", "_core"]:   # numpy._core[.x]
            candidates = [module, "numpy.core" + module[len("numpy._core"):]]
        else:
            candidates = [module]
        for cand in candidates:   # numpy 2 first; numpy 1.x has only .core
            try:
                __import__(cand)
                return super().find_class(cand, name)
            except ImportError:
                continue
        return super().find_class(module, name)


def load(filename: str) -> Any:
    """Load an lz4-frame pickle artifact (reference utils.py:32-37)."""
    with open(filename, "rb") as fin:
        buf = fin.read()
    return _Unpickler(io.BytesIO(lz4f.decompress_frame(buf))).load()


def save(obj: Any, filename: str) -> None:
    """Save a picklable object as an lz4-frame pickle (reference
    utils.py:40-46)."""
    with open(filename, "wb") as fout:
        fout.write(lz4f.compress_frame(pickle.dumps(obj, protocol=5)))


def save_dict_to_json(d: Dict[str, Any], json_path: str) -> None:
    """Save a dict of float-castable values (reference utils.py:48-57)."""
    with open(json_path, "w") as f:
        json.dump({k: float(v) for k, v in d.items()}, f, indent=4)
