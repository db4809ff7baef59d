"""Probe: where the time of the knn kernels (``csrc/knn_und.cu``) goes.

    python -m deepmetv2_tpu_torch.probes.knn_breakdown

Builds variants of ``csrc/knn_und.cu`` (``VARIANTS``: parts of the main
kernel cut out, namely the selection, the distance products, the staging
of source rows and combinations; or 16 query rows per block) and times
``knn_kth`` and ``knn_extract`` of each, by CUDA events, on the DRN's
round-1 features of the first evaluation batch (``ckpts_syn_drn``,
synthetic 2000, seed 42, batch 40, N=2048).  A cut variant's outputs are
wrong by construction: only its time is read, and the difference from
``full`` is the cost of the part it cuts.  ``full`` (the shipped source)
and ``rows_16`` must equal the wrapper's outputs bit for bit.  Prints one
JSON line per variant, then the card's name and power limit.  It needs a
CUDA GPU and ``nvcc``; it writes only under ``build/kernels/probe/`` in the
checkout.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from deepmetv2_tpu_torch.probes import common

REPO = Path(__file__).resolve().parents[2]
DRN_CKPTS = REPO / "ckpts_syn_drn"
BATCH, K, CAP = 40, 16, 32

_NO_SELECT = [
    ("""    const int got = select_smallest(row, n, lane, kc,
                                    [&](int, float m, int) { last = m; });""",
     """    const int got = kc;
    last = row[lane];"""),
    ("""  float* dv = d2v_out + i * kc;
""", """  float* dv = d2v_out + i * kc;
  if (lane < kc) {
    io[lane] = 0;
    dv[lane] = row[lane];
  }
  return;
""")]
_NO_DOT = [("for (int v = 0; v < hp / 4; ++v) {",
            "for (int v = 0; v < 0; ++v) {")]
_NO_STAGE = [("""    if ((H & 3) == 0) {
      const int hv""", """    if (false) {
      const int hv"""), ("""    } else {
      for (int e = tid; e < rc * H;""", """    } else if (false) {
      for (int e = tid; e < rc * H;""")]

# 16 query rows per block (128 KB of d² rows, one block per SM) in place
# of 8: each staged source row serves twice the queries
_ROWS_16 = [("constexpr int MAX_ROWS = 8;", "constexpr int MAX_ROWS = 16;"),
            ("constexpr int ROW_BUDGET = 64 * 1024;",
             "constexpr int ROW_BUDGET = 128 * 1024;"),
            ("__launch_bounds__(MAX_ROWS * 32, 2)",
             "__launch_bounds__(MAX_ROWS * 32, 1)")]

# variant -> (old, new) replacements in csrc/knn_und.cu
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "no_select": _NO_SELECT,
    "no_dot": _NO_DOT,
    "no_stage": _NO_STAGE,
    "no_dot_no_stage": _NO_DOT + _NO_STAGE,
    "no_dot_no_stage_no_select": _NO_DOT + _NO_STAGE + _NO_SELECT,
    "rows_16": _ROWS_16,
}
EXACT = ("full", "rows_16")   # variants that compute the whole function


def variant_source(name: str) -> str:
    """``csrc/knn_und.cu`` with the variant's replacements."""
    return common.variant_source("knn_und", VARIANTS, name)


def probe_inputs(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h [40, 2048, 64], mask [40, 2048])``: the DRN's round-1 features
    (its inputnet) of the first validation batch at batch 40."""
    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.drn import DRN
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint

    cfg = load_run_config(str(DRN_CKPTS))
    payload = load_checkpoint(str(DRN_CKPTS / "best.ckpt"))
    model = DRN(cfg.drn, device=device).params_from_jax(
        payload["params"], payload["bn_state"]).eval()
    loader = fetch_dataloader(events=synthetic_events(2000, seed=42),
                              batch_size=BATCH, validation_split=0.2,
                              buckets=cfg.data.node_buckets)["test"]
    batch = to_device(next(iter(loader)), device)
    x = torch.cat([batch.x_cont, batch.x_cat.to(batch.x_cont.dtype)], dim=-1)
    with torch.no_grad():
        h = model.inputnet(model.datanorm * x, final_act=True)
    return h.contiguous(), batch.mask.contiguous()


def run(device, reps: int = 20) -> Dict[str, Dict[str, float]]:
    """Per variant: ``knn_kth`` and ``knn_extract`` ms on the probe's
    inputs.  Raises if an ``EXACT`` variant differs from the wrapper's
    kernels."""
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_extract, knn_kth

    h, mask = probe_inputs(device)
    B, N, H = h.shape
    t, sq = knn_kth(h, mask, K)
    idx0, d2v0, rel0 = knn_extract(h, mask, t, sq, CAP, True)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    libs = common.build_variants("knn_und", VARIANTS)
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        kth, ext = lib.knn_kth, lib.knn_extract
        kth.argtypes = [P] * 6 + [I] * 4 + [P]
        ext.argtypes = [P] * 9 + [I] * 5 + [P]
        kth.restype = ext.restype = ctypes.c_int
        sq_v, t_v = torch.empty_like(sq), torch.empty_like(t)
        perm = torch.empty((B, N), dtype=torch.int32, device=device)
        cnt = torch.empty((B,), dtype=torch.int32, device=device)
        idx, d2v = torch.empty_like(idx0), torch.empty_like(d2v0)
        rel = torch.empty_like(rel0)

        def run_kth():
            if kth(h.data_ptr(), mask.data_ptr(), sq_v.data_ptr(),
                   t_v.data_ptr(), perm.data_ptr(), cnt.data_ptr(), B, N, H,
                   K, stream):
                raise RuntimeError(f"knn_breakdown: {name} knn_kth failed")

        def run_ext():
            if ext(h.data_ptr(), mask.data_ptr(), t.data_ptr(), sq.data_ptr(),
                   idx.data_ptr(), d2v.data_ptr(), rel.data_ptr(),
                   perm.data_ptr(), cnt.data_ptr(), B, N, H, CAP, 0, stream):
                raise RuntimeError(f"knn_breakdown: {name} knn_extract failed")

        if name in EXACT:
            run_kth()
            run_ext()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in
                       ((t_v, t), (sq_v, sq), (idx, idx0), (d2v, d2v0),
                        (rel, rel0))):
                raise AssertionError(f"knn_breakdown: variant {name} "
                                     "differs from the wrapper's kernels")
        out[name] = {"kth_ms": common.ms(run_kth, reps),
                     "extract_ms": common.ms(run_ext, reps)}
    return out


def main() -> int:
    device = common.cuda_device("knn_breakdown")
    if device is None:
        return 1
    for name, row in run(device).items():
        print(json.dumps(dict(variant=name, shape=[BATCH, 2048, 64], **row)),
              flush=True)
    common.print_device()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
