"""Probe: where the time of the edge-MLP kernels (``csrc/edge_mlp.cu``) goes.

    python -m deepmetv2_tpu_torch.probes.edge_mlp_breakdown

Builds variants of ``csrc/edge_mlp.cu`` (``VARIANTS``: one part of the
forward's or the backward's edge kernel cut out) and times ``edge_mlp_fwd``
on the DRN's round-1 graph of the first evaluation batch (``ckpts_syn_drn``,
synthetic 2000, seed 42, batch 40, N=2048) and ``edge_mlp_bwd`` on that of
the first train batch (batch 16; aggr add, seeded cotangents), by CUDA
events, through the wrappers with the variant's library in place.  A cut
variant's outputs are wrong by construction: only its time is read, and
the difference from ``full`` is the cost of the part it cuts.  ``full``
(the shipped source) must equal the wrapper's outputs bit for bit.  Then
the device time of each kernel of one ``full`` call (torch.profiler).
Prints one JSON line per variant, one per pass's kernels, then the card's
name and power limit.  It needs a CUDA GPU and ``nvcc``; it writes only
under ``build/kernels/probe/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.probes import common
from deepmetv2_tpu_torch.probes.knn_breakdown import REPO, probe_inputs

TRAIN_BATCH, K, CAP = 16, 16, 32


def _skip(comment_end: str) -> List[Tuple[str, str]]:
    """Skip the loop right after the source comment ending in
    ``comment_end``."""
    return [(f"{comment_end}\n    for", f"{comment_end}\n    if (false) for")]


_GATHER_FWD = "gather_z0<false>(Pb, a0, gm, ne, F1, F1s, ts, st);"
_GATHER_BWD = "gather_z0<false>(Pb, a0, gm, ne, F1, F1s, es, SE);"

# variant -> (old, new) replacements in csrc/edge_mlp.cu
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    # forward: the gather of e0 rows, the second layer's product, the fold
    "fwd_no_gather": [(_GATHER_FWD, "")],
    "fwd_no_product": [("gemm_nn<NH>(ts, st, w1s, SW, F1, ty, tx, acc);",
                        "")],
    "fwd_no_fold": _skip("folded in ascending slot order"),
    # backward: the gather, z1, the (node, output) pass, dW1, de0, the
    # gather of elu'(z0), the node sums and dz0 rows out
    "bwd_no_gather": [(_GATHER_BWD, "")],
    "bwd_no_z1": [("gemm_nn<NH>(es, SE, w1s, SW, F1, ty, tx, z);", "")],
    "bwd_no_dh": _skip("ties counted first"),
    "bwd_no_dw1": _skip("over the tile's edges in order"),
    "bwd_no_de0": [("gemm_nt<4 * NF>(ds, SW, w1s, SW, H2, ty, tx, d);", "")],
    "bwd_no_regather": [
        ("gather_z0<true>(Pb, a0, gm, ne, F1, F1s, es, SE);", "")],
    "bwd_no_out": _skip("each slot's dz0 row out") + [(
        "const int f4n = F1s >> 2;\n    for",
        "const int f4n = F1s >> 2;\n    if (false) for")],
}


def variant_source(name: str) -> str:
    """``csrc/edge_mlp.cu`` with the variant's replacements."""
    return common.variant_source("edge_mlp", VARIANTS, name)


@contextlib.contextmanager
def _library(path: Path):
    """The wrappers of ops/cuda/edge_mlp.py call into ``path`` meanwhile."""
    fns = {k: v for k, v in build._fns.items() if k.startswith("edge_mlp.")}
    lib = build._libs.get("edge_mlp")
    for k in fns:
        del build._fns[k]
    build._libs["edge_mlp"] = ctypes.CDLL(str(path))
    try:
        yield
    finally:
        for k in [k for k in build._fns if k.startswith("edge_mlp.")]:
            del build._fns[k]
        build._fns.update(fns)
        if lib is None:
            del build._libs["edge_mlp"]
        else:
            build._libs["edge_mlp"] = lib


def _conv_inputs(model, h, mask):
    """The round-1 conv's kernel arguments on ``h``'s fused graph: ``(a, x,
    nbr, w_diff, w1, b1)``."""
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph

    nbr, _, _ = knn_und_graph(h, mask, k=K, cap=CAP)
    mlp = model.convs[0].mlp.params()
    H = h.shape[-1]
    w0, b0 = mlp["lin0"]["w"].detach(), mlp["lin0"]["b"].detach()
    w_diff = w0[H:].contiguous()
    with torch.no_grad():
        a = torch.matmul(h, w0[:H] - w_diff) + b0
    return (a, h, nbr, w_diff, mlp["lin1"]["w"].detach(),
            mlp["lin1"]["b"].detach())


def probe_args(device):
    """``(fwd_args, bwd_args)``: the forward's arguments on the evaluation
    batch (aggr add), and the backward's on the first train batch with its
    forward's sum and seeded cotangents."""
    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.drn import DRN
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import edge_mlp_fwd
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint

    cfg = load_run_config(str(REPO / "ckpts_syn_drn"))
    payload = load_checkpoint(str(REPO / "ckpts_syn_drn" / "best.ckpt"))
    model = DRN(cfg.drn, device=device).params_from_jax(
        payload["params"], payload["bn_state"]).eval()
    fwd = _conv_inputs(model, *probe_inputs(device)) + ("add",)
    loader = fetch_dataloader(events=synthetic_events(2000, seed=42),
                              batch_size=TRAIN_BATCH)["train"]
    batch = to_device(next(iter(loader)), device)
    x = torch.cat([batch.x_cont, batch.x_cat.to(batch.x_cont.dtype)], dim=-1)
    with torch.no_grad():
        h = model.inputnet(model.datanorm * x, final_act=True).contiguous()
    args = _conv_inputs(model, h, batch.mask)
    with torch.no_grad():
        agg0, _, _ = edge_mlp_fwd(*args, "add")
    gen = torch.Generator(device=device).manual_seed(0)
    g0 = torch.randn(agg0.shape, generator=gen, device=device)
    gst = 1e-3 * torch.randn((2, agg0.shape[-1]), generator=gen,
                             device=device)
    return fwd, args + ("add", agg0, None, g0, None, gst)


def kernel_times(fn, reps: int = 5) -> List[dict]:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            out.append({"ms": us / reps / 1e3, "calls": e.count // reps,
                        "name": e.key[:60]})
    return sorted(out, key=lambda k: -k["ms"])


def run(device, reps: int = 20) -> Dict[str, Dict[str, float]]:
    """Per variant: ``edge_mlp_fwd`` and ``edge_mlp_bwd`` ms on the probe's
    inputs, and ``kernels``: the device time of each kernel of the full
    source's two calls.  Raises if ``full`` differs from the wrapper."""
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import (edge_mlp_bwd,
                                                       edge_mlp_fwd)

    fwd_args, bwd_args = probe_args(device)
    with torch.no_grad():
        want = edge_mlp_fwd(*fwd_args), edge_mlp_bwd(*bwd_args)
    out = {}
    for name, path in common.build_variants("edge_mlp",
                                             VARIANTS).items():
        with _library(path), torch.no_grad():
            if name == "full":
                got = edge_mlp_fwd(*fwd_args), edge_mlp_bwd(*bwd_args)
                torch.cuda.synchronize()
                flat = [t for part in (got, want) for t in part[0] + part[1]]
                n = len(flat) // 2
                if not all(a is b is None or torch.equal(a, b)
                           for a, b in zip(flat[:n], flat[n:])):
                    raise AssertionError("edge_mlp_breakdown: full differs "
                                         "from the wrapper's kernels")
                out["kernels"] = {
                    "fwd": kernel_times(lambda: edge_mlp_fwd(*fwd_args)),
                    "bwd": kernel_times(lambda: edge_mlp_bwd(*bwd_args))}
            out[name] = {"fwd_ms": common.ms(lambda: edge_mlp_fwd(*fwd_args),
                                             reps),
                         "bwd_ms": common.ms(lambda: edge_mlp_bwd(*bwd_args),
                                             reps)}
    return out


def main() -> int:
    device = common.cuda_device("edge_mlp_breakdown")
    if device is None:
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run(device)
    kernels = res.pop("kernels")
    for name, row in res.items():
        print(json.dumps(dict(variant=name, **row)), flush=True)
    for name, rows in kernels.items():
        print(json.dumps({"kernels": name, "rows": rows}), flush=True)
    common.print_device()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
