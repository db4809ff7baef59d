"""Probe: where the time of the knn kernels (``csrc/knn_und.cu``) goes.

    python -m deepmetv2_tpu_torch.probes.knn_breakdown

Builds variants of ``csrc/knn_und.cu`` (``VARIANTS``: parts of the main
kernel cut out, namely the selection (the member test, the filter and the
queues), the distance tile's products, the staging of the query and source
slices, and combinations; a query tile of 128 rows in place of 64; and a
counting build) and times ``knn_kth`` and ``knn_extract`` of each, by CUDA
events, at three shapes: the DRN's round-1 features of the first evaluation
batch (``ckpts_syn_drn``, synthetic 2000, seed 42, batch 40, N=2048), and
the cells' shapes, 40 events of 500-5000 candidates (``cell_inputs``) at
N=8192 and N=6144.  A cut variant's outputs are wrong by construction: only
its time is read, and the difference from ``full`` is the cost of the part
it cuts.  ``full`` (the shipped source), ``rows_128`` and ``count`` must
equal the wrapper's outputs bit for bit.  ``count`` also reports, per call,
the share of the real pairs that passed their row's running threshold
(``pass_share``) and the queue merges per real row (mean and max); its time
is not the shipped kernel's.  Prints one JSON line per variant and shape,
then the card's name and power limit.  It needs a CUDA GPU and ``nvcc``; it
writes only under ``build/kernels/probe/`` in the checkout.
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
CELL_NS = (8192, 6144)    # the DRN cells' round-1 bucket, and 6144
CELL_COUNTS = (500, 5000)  # real candidates per event, drawn uniformly
CELL_SEED = 22

# the selection cut: the chunk's products feed one sum, stored only if it
# takes a value no run gives, so that they are computed and nothing else
_NO_SELECT = [
    ("  float acc[TR][TC];\n", "  float acc[TR][TC];\n  float sink = 0.f;\n"),
    ("    if (++ks < nks) continue;\n",
     """    if (++ks < nks) continue;
    ks = 0;
    ++c;
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int cc = 0; cc < TC; ++cc) sink = __fadd_rn(sink, acc[r][cc]);
    if (ks == 0) continue;
"""),
    ("  // the queues' last keys, then each row's outputs from its list\n",
     "  if (sink == 1.5f) (EXTRACT ? d2v_out : t_out)[eb] = sink;\n")]
_NO_DOT = [("      acc[r][cc] = d;\n", "")]
_NO_STAGE = [("          __pipeline_memcpy_async(dst, src, 16);",
              "          if (v < 0) __pipeline_memcpy_async(dst, src, 16);")]

# a query tile of 128 rows and an 8 x 4 thread tile (256 threads, two
# blocks an SM) in place of 64 rows and 4 x 4 (three blocks an SM): each
# staged source slice serves twice the rows, with half the warps an SM
_ROWS_128 = [("constexpr int TR = 4;", "constexpr int TR = 8;"),
             ("constexpr int Q = 64;", "constexpr int Q = 128;"),
             ("__launch_bounds__(THREADS, 3)", "__launch_bounds__(THREADS, 2)")]

# per real row, the keys it queued (pairs past its running threshold) and
# the merges of a non-empty queue, added into the buffer knn_count_into
# names
_COUNT = [
    ("namespace {\n\ntypedef",
     "__device__ int* knn_counts;  // per row: keys queued, merges\n\n"
     "namespace {\n\ntypedef"),
    ("        qn[r] += __popc(bal & mine);\n",
     "        if (hl == 0 && (bal & mine))\n"
     "          atomicAdd(knn_counts + 2 * (eb + qid_s[row]),"
     " __popc(bal & mine));\n"
     "        qn[r] += __popc(bal & mine);\n"),
    ("          top = merge(lr, qr, kc, qn[r], hl);\n",
     "          if (hl == 0 && qn[r] > 0)\n"
     "            atomicAdd(knn_counts + 2 * (eb + qid_s[row]) + 1, 1);\n"
     "          top = merge(lr, qr, kc, qn[r], hl);\n"),
    ("    if (__any_sync(FULL, qn[r] > 0))\n",
     "    if (hl == 0 && qn[r] > 0)\n"
     "      atomicAdd(knn_counts + 2 * (eb + qid_s[qy * TR + r]) + 1, 1);\n"
     "    if (__any_sync(FULL, qn[r] > 0))\n"),
    ('}  // extern "C"',
     'int knn_count_into(int* counts) {\n'
     '  return static_cast<int>(\n'
     '      cudaMemcpyToSymbol(knn_counts, &counts, sizeof(counts)));\n'
     '}\n\n}  // extern "C"')]

# variant -> (old, new) replacements in csrc/knn_und.cu
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "no_select": _NO_SELECT,
    "no_dot": _NO_DOT,
    "no_stage": _NO_STAGE,
    "no_dot_no_stage": _NO_DOT + _NO_STAGE,
    "no_dot_no_stage_no_select": _NO_DOT + _NO_STAGE + _NO_SELECT,
    "rows_128": _ROWS_128,
    "count": _COUNT,
}
EXACT = ("full", "rows_128", "count")   # variants that compute the function


def variant_source(name: str) -> str:
    """``csrc/knn_und.cu`` with the variant's replacements."""
    return common.variant_source("knn_und", VARIANTS, name)


def probe_inputs(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h [40, 2048, 64], mask [40, 2048])``: the DRN's round-1 features
    (its inputnet) of the first validation batch at batch 40."""
    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)

    cfg = load_run_config(str(DRN_CKPTS))
    loader = fetch_dataloader(events=synthetic_events(2000, seed=42),
                              batch_size=BATCH, validation_split=0.2,
                              buckets=cfg.data.node_buckets)["test"]
    return _features(to_device(next(iter(loader)), device), device)


def cell_inputs(device, N: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h [40, N, 64], mask [40, N])``: the DRN's round-1 features of 40
    synthetic events of 500-5000 candidates each (numpy seed ``CELL_SEED``),
    padded to N, as the DRN cells' batches are."""
    from deepmetv2_tpu_torch.data import synthetic_events, to_device
    from deepmetv2_tpu_torch.data.batching import collate

    events = synthetic_events(BATCH, seed=CELL_SEED, n_min=CELL_COUNTS[0],
                              n_max=CELL_COUNTS[1])
    return _features(to_device(collate(events, pad_to=N), device), device)


def _features(batch, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DRN's (``ckpts_syn_drn``) round-1 features of ``batch``."""
    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.models.drn import DRN
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint

    cfg = load_run_config(str(DRN_CKPTS))
    payload = load_checkpoint(str(DRN_CKPTS / "best.ckpt"))
    model = DRN(cfg.drn, device=device).params_from_jax(
        payload["params"], payload["bn_state"]).eval()
    x = torch.cat([batch.x_cont, batch.x_cat.to(batch.x_cont.dtype)], dim=-1)
    with torch.no_grad():
        h = model.inputnet(model.datanorm * x, final_act=True)
    return h.contiguous(), batch.mask.contiguous()


def count_summary(counts: torch.Tensor, mask: torch.Tensor
                  ) -> Dict[str, float]:
    """From the counting build's ``[B, N, 2]`` (keys queued, merges) per
    row: the share of the real pairs (each real row against every other
    real source of its event) that passed their row's running threshold,
    and the merges per real row."""
    n = mask.sum(dim=1).double()
    real = counts[mask]
    merges = real[:, 1].double()
    return {"pass_share": float(real[:, 0].double().sum()
                                / (n * (n - 1)).sum().clamp(min=1)),
            "merges_mean": float(merges.mean()) if len(merges) else 0.0,
            "merges_max": int(merges.max()) if len(merges) else 0}


def _shapes(device):
    yield "probe", probe_inputs(device)
    for N in CELL_NS:
        yield f"cells_{N}", cell_inputs(device, N)


def run(device, reps: int = 20, variants=None) -> List[Dict]:
    """Per variant and shape: ``knn_kth`` and ``knn_extract`` ms (and the
    counting build's counts).  Raises if an ``EXACT`` variant differs from
    the wrapper's kernels."""
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_extract, knn_kth

    variants = VARIANTS if variants is None else variants
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    libs = {}
    for name, path in common.build_variants("knn_und", variants).items():
        lib = ctypes.CDLL(str(path))
        lib.knn_kth.argtypes = [P] * 6 + [I] * 4 + [P]
        lib.knn_extract.argtypes = [P] * 9 + [I] * 5 + [P]
        lib.knn_kth.restype = lib.knn_extract.restype = ctypes.c_int
        libs[name] = lib
    out = []
    for shape, (h, mask) in _shapes(device):
        B, N, H = h.shape
        t, sq = knn_kth(h, mask, K)
        idx0, d2v0, rel0 = knn_extract(h, mask, t, sq, CAP, N <= 2048)
        for name, lib in libs.items():
            sq_v, t_v = torch.empty_like(sq), torch.empty_like(t)
            perm = torch.empty((B, N), dtype=torch.int32, device=device)
            cnt = torch.empty((B,), dtype=torch.int32, device=device)
            idx, d2v = torch.empty_like(idx0), torch.empty_like(d2v0)
            rel = None if rel0 is None else torch.empty_like(rel0)

            def run_kth():
                if lib.knn_kth(h.data_ptr(), mask.data_ptr(), sq_v.data_ptr(),
                               t_v.data_ptr(), perm.data_ptr(),
                               cnt.data_ptr(), B, N, H, K, stream):
                    raise RuntimeError(f"knn_breakdown: {name} knn_kth "
                                       "failed")

            def run_ext():
                if lib.knn_extract(h.data_ptr(), mask.data_ptr(),
                                   t.data_ptr(), sq.data_ptr(),
                                   idx.data_ptr(), d2v.data_ptr(),
                                   None if rel is None else rel.data_ptr(),
                                   perm.data_ptr(), cnt.data_ptr(), B, N, H,
                                   CAP, 0, stream):
                    raise RuntimeError(f"knn_breakdown: {name} knn_extract "
                                       "failed")

            row = {"variant": name, "shape": shape, "dims": [B, N, H]}
            if name in EXACT:
                counts = torch.zeros((B, N, 2), dtype=torch.int32,
                                     device=device)
                for fn, what in ((run_kth, "kth"), (run_ext, "extract")):
                    if name == "count":
                        counts.zero_()
                        if lib.knn_count_into(ctypes.c_void_p(
                                counts.data_ptr())):
                            raise RuntimeError("knn_breakdown: count buffer")
                    fn()
                    torch.cuda.synchronize()
                    if name == "count":
                        for key, v in count_summary(counts, mask).items():
                            row[f"{what}_{key}"] = v
                pairs = [(t_v, t), (sq_v, sq), (idx, idx0), (d2v, d2v0)]
                if rel is not None:
                    pairs.append((rel, rel0))
                if not all(torch.equal(a, b) for a, b in pairs):
                    raise AssertionError(f"knn_breakdown: variant {name} "
                                         f"differs from the wrapper's kernels "
                                         f"at {shape}")
            row["kth_ms"] = common.ms(run_kth, reps)
            row["extract_ms"] = common.ms(run_ext, reps)
            out.append(row)
    return out


def main() -> int:
    device = common.cuda_device("knn_breakdown")
    if device is None:
        return 1
    for row in run(device):
        print(json.dumps(row), flush=True)
    common.print_device()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
