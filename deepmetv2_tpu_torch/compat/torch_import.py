"""Reference ``.pth.tar`` checkpoints → the JAX package's parameter layout
(the JAX package's ``compat/torch_import.py``).

The reference saves ``{epoch, state_dict, optim_dict, sched_dict}``
(reference train.py:110-113, utils.py:59-79).  ``import_torch_checkpoint``
turns the ``state_dict`` of its trained ``Net`` (GraphMETNetwork) into the
``(params, bn_state)`` trees that ``GraphMET.params_from_jax`` reads, the
same trees, leaf for leaf, as the JAX importer gives:

* ``nn.Linear.weight`` ``[out, in]`` becomes ``w [in, out]``;
* PyG EdgeConv's edge Linear ``[H, 2H]`` becomes ``[2H, H]``, rows [0:H]
  on x_i ("self") and [H:2H] on x_j − x_i ("diff"), the layout of
  ops/edgeconv.py's ``a_i + c_j`` factorization;
* BatchNorm running statistics go to ``bn_state`` as ``BatchNormState``,
  ``num_batches_tracked`` as its int32 ``count``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from deepmetv2_tpu_torch.nn.core import BatchNormState


def _load_state_dict(path: str):
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return {k: v.detach() for k, v in sd.items()}, ckpt


def _lin(sd, prefix: str) -> Dict[str, torch.Tensor]:
    return {"w": sd[f"{prefix}.weight"].T.contiguous(),
            "b": sd[f"{prefix}.bias"]}


def _bn(sd, prefix: str):
    params = {"gamma": sd[f"{prefix}.weight"], "beta": sd[f"{prefix}.bias"]}
    state = BatchNormState(
        mean=sd[f"{prefix}.running_mean"],
        var=sd[f"{prefix}.running_var"],
        count=sd[f"{prefix}.num_batches_tracked"].to(torch.int32))
    return params, state


def import_torch_checkpoint(path: str
                            ) -> Tuple[Dict[str, Any], Dict[str, Any],
                                       Dict[str, Any]]:
    """A reference ``.pth.tar`` → ``(params, bn_state, meta)``, CPU tensors
    in the JAX package's layout.  ``meta`` holds the epoch, the optimizer's
    param groups and the plateau scheduler's state."""
    sd, ckpt = _load_state_dict(path)
    g = "graphnet"
    params: Dict[str, Any] = {
        "embed_charge": {"w": sd[f"{g}.embed_charge.weight"]},
        "embed_pdgid": {"w": sd[f"{g}.embed_pdgid.weight"]},
        "embed_pv": {"w": sd[f"{g}.embed_pv.weight"]},
        "embed_continuous": _lin(sd, f"{g}.embed_continuous.0"),
        "embed_categorical": _lin(sd, f"{g}.embed_categorical.0"),
        "encode_all": _lin(sd, f"{g}.encode_all.0"),
        "output": {"lin0": _lin(sd, f"{g}.output.0"),
                   "lin1": _lin(sd, f"{g}.output.2")},
    }
    params["bn_all"], bn_all = _bn(sd, f"{g}.bn_all")
    state: Dict[str, Any] = {"bn_all": bn_all, "convs": []}
    params["convs"] = []
    depth = 0
    while f"{g}.conv_continuous.{depth}.0.nn.0.weight" in sd:
        edge = _lin(sd, f"{g}.conv_continuous.{depth}.0.nn.0")
        bn_p, bn_s = _bn(sd, f"{g}.conv_continuous.{depth}.1")
        params["convs"].append({"edge": edge, "bn": bn_p})
        state["convs"].append(bn_s)
        depth += 1
    meta = {
        "epoch": int(ckpt.get("epoch", 0)),
        "optim": (ckpt.get("optim_dict") or {}).get("param_groups", None),
        "sched": ckpt.get("sched_dict", None),
    }
    return params, state, meta
