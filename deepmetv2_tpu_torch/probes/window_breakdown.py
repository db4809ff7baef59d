"""Probe: where the time of the window-max kernels (``csrc/window_max.cu``)
goes.

    python -m deepmetv2_tpu_torch.probes.window_breakdown

Builds variants of ``csrc/window_max.cu`` (``VARIANTS``: the chunk prune
turned off; parts of the forward's and the backward's kernels cut out: the
selection loop, the ballots with it, the staging of the kept chunks' rows;
or an alternative to one of the design's choices: one set bit per
selection step, as the first design took them, or 16 warps per block in
place of 8) and times ``window_max_fwd`` at the evaluation shape and at
the training shape and ``window_max_bwd`` at the training shape, by CUDA
events, on the inputs of ``chip_smoke.py``'s kernel lines
(``probe_inputs``), every variant in each of two rounds.  A cut variant's
outputs are wrong by construction: only its time is read, and the
difference from ``full`` is the cost of the part it cuts.  The ``EXACT``
variants (the shipped source, ``full``, the prune off and the
alternatives) compute the whole function and must equal the wrapper's
outputs bit for bit.  Prints one JSON line per variant and round, then the
card's name and power limit.  It needs a CUDA GPU and ``nvcc``; it writes
only under ``build/kernels/probe/`` in the checkout.
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.probes import common

R = 0.4
EVAL_B, EVAL_HALO = 40, 128
TRAIN_B, TRAIN_HALO = 8, 192
N, H = 2048, 32

_NO_PRUNE = [("if (lane == 0) keep[k] = any != 0u && "
              "!boxes_apart(rows_box, b, r2);",
              "if (lane == 0) keep[k] = 1;")]
# the selection: the set bits' rows are never read (the ballot stays)
_NO_SELECT = [("      while (bits) {   // two sources per step",
               "      if (bits == 0x5eedu) {   // two sources per step"),
              ("      while (bits) {   // ascending q, two queries per step",
               "      if (bits == 0x5eedu) {   // ascending q, two queries")]
# one set bit per selection step (the first design's loop)
_SELECT_ONE = [("const int k2 = bits ? __ffs(bits) - 1 : k;\n"
                "        bits &= bits - 1;\n", "const int k2 = k;\n"),
               ("const int k2 = bits ? __ffs(bits) - 1 : -1;\n"
                "        bits &= bits - 1;\n", "const int k2 = -1;\n")]
# the predicates and ballots, and the selection with them
_NO_BALLOT = [("if (!((mine >> j) & 1u)) continue;   // padded query row",
               "if (true) continue;   // padded query row"),
              ("if (!((mine >> j) & 1u)) continue;   // padded source row",
               "if (true) continue;   // padded source row")]
# the kept chunks' rows are not staged (the plan, the barriers stay)
_NO_STAGE = [("    stage_rows(c_s + (i & 1) * CHUNK * H, "
              "cb + static_cast<size_t>(s0) * H,\n"
              "               min(CHUNK, hi - s0), H, vec);\n", ""),
             ("    stage_rows(m_s + (i & 1) * CHUNK * H, m + off, rows, H, "
              "vec);\n    stage_rows(g_s + (i & 1) * CHUNK * H, g + off, "
              "rows, H, vec);\n", "")]

# variant -> (old, new) replacements in csrc/window_max.cu
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "no_prune": _NO_PRUNE,
    "no_select": _NO_SELECT,
    "no_ballot": _NO_BALLOT,
    "no_stage": _NO_STAGE,
    "no_ballot_no_stage": _NO_BALLOT + _NO_STAGE,
    # the shipped design's choices, each undone
    "select_one": _SELECT_ONE,
    "warps_16": [("constexpr int WARPS = 8; ", "constexpr int WARPS = 16;")],
}
# variants that compute the whole function
EXACT = ("full", "no_prune", "select_one", "warps_16")


def variant_source(name: str) -> str:
    """``csrc/window_max.cu`` with the variant's replacements."""
    return common.variant_source("window_max", VARIANTS, name)


def probe_inputs(device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, int]]:
    """``{"eval": (c, pos, halo), "train": (c, pos, halo)}``: the inputs of
    ``chip_smoke.py``'s kernel lines.  eval: 40 synthetic events (seed 7)
    padded to N=2048 and sorted by eta, halo 128; train: 8 events (seed 7)
    in the train CLI's cell order, halo 192; padded rows at ``PAD_POS``,
    c seeded normal [B, N, 32]."""
    from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device
    from deepmetv2_tpu_torch.data.sorting import cell_sort_batch, sort_by_eta
    from deepmetv2_tpu_torch.ops.window import padded_pos

    def pos_of(batch):
        phi = torch.atan2(batch.x_cont[..., 1], batch.x_cont[..., 0])
        etaphi = torch.stack([batch.x_cont[..., 3], phi], dim=-1)
        return padded_pos(etaphi, batch.mask)

    rng = np.random.default_rng(0)
    ev, _ = sort_by_eta(to_device(collate(synthetic_events(EVAL_B, seed=7),
                                          pad_to=N), device))
    tr = to_device(cell_sort_batch(collate(synthetic_events(TRAIN_B, seed=7),
                                           pad_to=N), r=R), device)
    out = {}
    for name, batch, halo in (("eval", ev, EVAL_HALO),
                              ("train", tr, TRAIN_HALO)):
        c = torch.as_tensor(rng.normal(size=(batch.batch_size, N, H))
                            .astype(np.float32), device=device)
        out[name] = (c, pos_of(batch), halo)
    return out


def _variant_calls(name: str, path, inputs, want, g, stream):
    """Calls of variant ``name``'s kernels (library ``path``) on the probe's
    inputs: ``{"fwd_eval": f, "fwd_train": f, "bwd_train": f}``, each
    writing its own output, and those outputs."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(path))
    fwd, bwd = lib.window_max_fwd, lib.window_max_bwd
    fwd.argtypes = [P] * 3 + [I] * 4 + [F, P]
    bwd.argtypes = [P] * 5 + [I] * 4 + [F, P]
    fwd.restype = bwd.restype = ctypes.c_int
    r2 = R ** 2
    outs = {k: torch.empty_like(v) for k, v in want.items()}

    def fwd_call(k):
        c, pos, halo = inputs[k]

        def call():
            if fwd(c.data_ptr(), pos.data_ptr(), outs[f"fwd_{k}"].data_ptr(),
                   c.shape[0], N, H, halo, r2, stream):
                raise RuntimeError(f"window_breakdown: {name} forward failed")
        return call

    def bwd_call():
        c, pos, halo = inputs["train"]
        if bwd(c.data_ptr(), pos.data_ptr(), want["fwd_train"].data_ptr(),
               g.data_ptr(), outs["bwd_train"].data_ptr(), TRAIN_B, N, H,
               halo, r2, stream):
            raise RuntimeError(f"window_breakdown: {name} backward failed")

    calls = {f"fwd_{k}": fwd_call(k) for k in inputs}
    calls["bwd_train"] = bwd_call
    return calls, outs


def run(device, reps: int = 50, rounds: int = 2) -> List[Dict]:
    """Per round and variant: the forward's ms at both shapes and the
    backward's at the training shape.  Raises if an ``EXACT`` variant
    differs from the wrapper's kernels."""
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)

    inputs = probe_inputs(device)
    r2 = R ** 2
    want = {f"fwd_{k}": window_max(c, pos, r2, halo)
            for k, (c, pos, halo) in inputs.items()}
    c, pos, halo = inputs["train"]
    g = torch.as_tensor(np.random.default_rng(1).normal(size=tuple(c.shape))
                        .astype(np.float32), device=device)
    want["bwd_train"] = window_max_bwd(c, pos, want["fwd_train"], g, r2, halo)
    stream = torch.cuda.current_stream(device).cuda_stream
    variants = {}
    for name, path in common.build_variants("window_max", VARIANTS).items():
        calls, outs = _variant_calls(name, path, inputs, want, g, stream)
        if name in EXACT:
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            if not all(torch.equal(outs[k], want[k]) for k in want):
                raise AssertionError(f"window_breakdown: variant {name} "
                                     "differs from the wrapper's kernels")
        variants[name] = calls
    return [dict(round=rnd, variant=name,
                 **{f"{k}_ms": common.ms(call, reps)
                    for k, call in calls.items()})
            for rnd in range(rounds) for name, calls in variants.items()]


def main() -> int:
    device = common.cuda_device("window_breakdown")
    if device is None:
        return 1
    for row in run(device):
        print(json.dumps(dict(row, eval=[EVAL_B, N, H, EVAL_HALO],
                              train=[TRAIN_B, N, H, TRAIN_HALO])), flush=True)
    common.print_device()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
