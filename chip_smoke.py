#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (deepmetv2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one line:
  1. device: the card, and its name and power limit from nvidia-smi;
  2. build: every CUDA kernel source in csrc/, one nvcc each, in parallel,
     with each source's seconds and edge_mlp.cu's registers and spills per
     kernel;
  3. kernel: window_max forward against its plain PyTorch version, bitwise
     on every row (padded rows -inf), on (a) the evaluation shape (and
     through a pos view at an odd float offset), (b)
     clustered eta with value ties and pairs on the radius boundary, (c)
     padded nodes and empty events, (d) the training shape's cell-ordered
     batch on a 0.1 lattice (pairs on the radius across the chunk prune's
     gaps); with the kernel's time, the plain version's, the card's lower
     bound and the chunks the prune keeps (window_chunks_needed) against
     the window's chunks, at the evaluation shape and at the training
     shape (cell order, halo 192);
  4. kernel_bwd: window_max backward against its plain version, bitwise on
     every row (padded rows 0), on the same cases (every tied source takes
     the full gradient), the gradients of x, w and b through the EdgeConv
     wrapper against the plain path, and the backward's time and kept
     chunks at the training shape;
  5. evaluate: the port's evaluate CLI on 2000 synthetic events with the
     committed JAX weights (ckpts_syn/best.ckpt), held to the JAX package's
     validation loss, with the kernels' launches counted;
  6. predict: the port's predict CLI over the same 2000 events;
  7. train_resume: 10 train steps from ckpts_syn/best.ckpt (weights,
     BatchNorm state, AdamW moments, scheduler) through the chained runner
     (chains of 8 and 2), each loss held to the JAX package's;
     chain_replay: 24 steps from the same checkpoint eagerly, twice (what
     the card does run to run), and as 3 chains of 8 (eager warm-up, then
     a captured CUDA graph replayed twice, the lr changed before the
     third), every loss, parameter, BatchNorm buffer and AdamW moment and
     count bitwise equal to the eager run's (or within what the two eager
     runs differ by), the launches with replays equal to the eager run's,
     with the graphs, replays and peak memory of both;
  8. train: the port's train CLI, 2 epochs on synthetic 2000 and a resume
     to 3, chained and resident by the config's defaults (its "feed:" line
     checked), with the exact launch counts (replays included), each
     epoch's seconds, the artifacts, and its best.ckpt re-evaluated by the
     evaluate CLI;
  8b. neighbor_list mode (GraphMET on the radius graph's lists, capped at
     256, no kernel of its own): nl_evaluate, the evaluate CLI on
     synthetic 2000 held to GOLDEN_NL_LOSS with no window launch, its
     seconds and peak memory; nl_predict, the predict CLI over the 2000
     events (the checks of 6); from_torch, a reference .pth.tar of
     ckpts_syn's weights (write_reference_checkpoint) evaluated with
     --from_torch in window and neighbor_list mode, bitwise the native
     checkpoint's loss of 5 and of nl_evaluate; nl_train_resume, 10 steps
     from ckpts_syn/best.ckpt as chains of 8 and 2 held to
     GOLDEN_NL_TRAIN_LOSSES; nl_train, the train CLI for 1 epoch (its
     "feed:" line), its best.ckpt re-evaluated within REEVAL_RTOL;
  9. kernel_knn: the DRN's graph kernels knn_kth and knn_extract against
     their plain versions, bitwise (t, sq, idx, d2v, rel), on (a) the
     DRN's own round-1 features of an evaluation batch (B=40, N=2048,
     H=64, k=16, cap 32), (b) lattice features with many equal distances,
     (c) padded rows, an empty and a 3-node event at N=1536, (d) scattered
     masks with a hub at N=2048, N=1003 and H=13, (e) N=4096 and N=8192 at
     B=2, where the tiled matching's relation must be rel; padded rows must
     hold t=+inf, empty slots and a zero relation row; with both kernels' times
     at N=2048 and N=1536 beside the plain versions', the bounds and the
     times of the kernels' first design (KNN_FIRST_DESIGN_MS);
 10. kernel_edge_mlp: edge_mlp_fwd against its plain version for add,
     mean and max on the graph of (a), within GRAD_RTOL/GRAD_ATOL, its
     per-node first layer (edge_mlp_proj) against the plain product in
     f64, and its time at the evaluation shape;
 11. evaluate_drn: the evaluate CLI with --model drn on 2000 synthetic
     events at batch 8 (ckpts_syn_drn/best.ckpt), exact launch counts,
     the loss against a second pass over the same batches, and every
     event's MET and graph decisions against the JAX package's fused path
     (GOLDEN_DRN_MET, GOLDEN_DRN_GRAPHS): only events whose graphs differ
     may be off; the loss printed beside DRN_LOSS_FIRST_DESIGN;
 12. predict_drn: the predict CLI with --model drn over the 2000 events;
 13. profile: one evaluation step's and one train step's device time by
     kernel (torch.profiler), the same in neighbor_list mode with the
     radius build, the gather and its backward timed alone, and one DRN
     evaluation step's;
 14. kernel_edge_mlp_bwd: the DRN's edge-MLP backward against its plain
     version evaluated in f64, for add, mean and max on (a) the DRN's
     round-1 features of a train batch (B=16, N=2048) with the cotangents
     of a real train-mode loss, (b) rows of repeated prototypes (exact max
     ties, split evenly), (c) empty rows and padded events at N=1536, (d) a
     list cut to its two-way edges by want_mirror; two launches bitwise
     equal; the conv's gradients in train mode against the plain path in
     f64; the per-node gradient kernels (edge_mlp_node_grads) against
     their plain products in f64; the reverse index's kernels against
     reverse_slots (cases a–d and random lists at N=8192); its time at (a);
 15. drn_train_resume: 10 DRN train steps from ckpts_syn_drn/best.ckpt
     (weights, BatchNorm, the optax chain's AdamW state, scheduler), each
     loss held to GOLDEN_DRN_TRAIN_LOSSES by the rule stated there, and the
     first step's loss, gradients, parameters and BatchNorm buffers held
     to the port's plain train step in f64 on the same graphs;
     chain_replay: as in 7, for the DRN (batch 16, clip 10);
 16. drn_train: the train CLI with --model drn, 2 epochs and a resume to
     3, chained and resident (its "feed:" line checked), exact launch
     counts of all four DRN kernels (replays included), each epoch's
     seconds, the artifacts, and best.ckpt re-evaluated by the evaluate
     CLI;
 16b. drn_composed: the DRN over the 400 validation events at batch 8
     with the composed graph build and the gather-reduce conv, every
     event's MET and graph decisions held to the JAX package's composed
     path (GOLDEN_DRN_COMPOSED_MET, _GRAPHS) by the rule of 11, no DRN
     kernel launched; one train-mode backward with mirror_gather off and
     on, within DRN_MIRROR_ATOL of the largest gradient;
 17. probe: the pipelined window forward (the TPU revolver probe's port)
     bitwise against window_max_fwd and the plain version at both probe
     shapes, with times;
 18. profile: one DRN train step's device time by kernel; feed: for each
     family, one epoch of synthetic 2000 under per-step dispatch with a
     copy of each batch and under chained resident replay: ms per step,
     device ms per step and the idle share, beside the card's name and
     power limit;
then the whole run's seconds, a JSON line of every ported kernel and,
last, the device JSON line.
Any failed check exits non-zero before the last line.  Writes only under
build/ in the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CARD = ""    # the card's name and power limit from nvidia-smi (main)
GOLDEN_LOSS = 1.0319761037826538   # JAX package, cli.evaluate --synthetic 2000
LOSS_RTOL = 1e-4
# JAX package, make_train_step from ckpts_syn/best.ckpt on the first 10
# cell-sorted train batches of synthetic 2000 (seed 42, batch 8, halo 192),
# on the CPU: tests/test_torch_train.py:jax_resume_losses(10)
GOLDEN_TRAIN_LOSSES = (
    1.3795247077941895, 0.6131638288497925, 1.4182462692260742,
    0.6025028228759766, 0.8353334665298462, 0.8708364963531494,
    0.63520348072052, 0.5926302075386047, 1.1002800464630127,
    0.6679131984710693)
REEVAL_RTOL = 1e-6   # train CLI's metrics_val_best.json against cli.evaluate
# JAX package, cli.evaluate --graph_mode neighbor_list --synthetic 2000
# --restore_file best on ckpts_syn, on the CPU (the radius graph's lists,
# capped at the nearest 256, self-loops, no phi wrap)
GOLDEN_NL_LOSS = 1.0319758653640747
# JAX package, make_train_step in neighbor_list mode from ckpts_syn/best.ckpt
# on the first 10 train batches of synthetic 2000 (seed 42, batch 8,
# unsorted, as its train CLI leaves them in this mode), on the CPU:
# tests/test_torch_train.py:jax_nl_resume_losses(10)
GOLDEN_NL_TRAIN_LOSSES = (
    1.3795241117477417, 0.6131558418273926, 1.418241262435913,
    0.6025006175041199, 0.8353309631347656, 0.8708376884460449,
    0.635197103023529, 0.5926329493522644, 1.1002843379974365,
    0.6679155826568604)
GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-6   # atol times the largest |gradient|
R = 0.4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM, FP32 outside the tensor cores
TRAIN_B, TRAIN_N, TRAIN_HALO = 8, 2048, 192
# JAX package, the DRN validation loss of ckpts_syn_drn/best.ckpt on
# synthetic 2000 (seed 42, split 0.2, batch 8) through its fused path (the
# Pallas graph and conv kernels in interpret mode), on the CPU:
# tests/test_torch_drn.py:jax_drn_eval(2000, 8), which also gives each
# event's MET estimate (GOLDEN_DRN_MET) and its per-round graph digests
# (GOLDEN_DRN_GRAPHS, drn_graph_digests).
GOLDEN_DRN_LOSS = 41.40185546875
GOLDEN_DRN_MET = "tests/golden_drn_val_met.npy"
GOLDEN_DRN_GRAPHS = "tests/golden_drn_val_graphs.npy"
# ckpts_syn_drn/metrics_val_best.json: the JAX package's own TPU run,
# printed beside the port's loss as a reference, not a gate
JAX_TPU_DRN_LOSS = 67.19747924804688
DRN_CKPTS = "ckpts_syn_drn"
DRN_B, DRN_N, DRN_K, DRN_CAP = 40, 2048, 16, 32
DRN_EVENT_RTOL = 1e-4      # an event's MET against the JAX package's
# Only an event whose graph decisions (some round's neighbour lists or
# matching) differ from the JAX package's may miss DRN_EVENT_RTOL: a pair
# within a few ulps of a threshold is decided by the order of the d² sums
# (ROADMAP C).  Of the 400 validation events, at most this many may differ
# so: a fault in the graph build or the matching changes nearly every
# event, near-ties a few percent (the port on the CPU: 37, ROADMAP C,
# counted by tests/test_torch_drn.py:drn_divergence(2000, 8)).
DRN_MAX_GRAPH_EVENTS = 80
DRN_KEPT_RTOL = 1e-5       # the loss over the other events against JAX's
DRN_CLI_RTOL = 1e-6        # the CLI's loss against the checked pass's
# The evaluate CLI's DRN loss on an H100 80GB HBM3 with the edge-MLP
# kernels' first design (PERF.md's findings): the redesigned forward keeps
# its bits, so the loss is printed beside it (not a gate: the dense
# matching's torch products may round otherwise under another torch)
DRN_LOSS_FIRST_DESIGN = 41.38379669189453
DRN_TRAIN_B, DRN_REFRESH = 16, 30   # ckpts_syn_drn's batch, bn_refresh_batches
# JAX package, its DRN train step (fused path, Pallas in interpret mode)
# from ckpts_syn_drn/best.ckpt with the optax chain (clip 10, AdamW) on the
# first 10 train batches of synthetic 2000 (seed 42, batch 16), on the CPU:
# tests/test_torch_drn_train.py:jax_drn_resume_losses(10), which also gives
# each step's per-event graph digests (GOLDEN_DRN_TRAIN_GRAPHS).
GOLDEN_DRN_TRAIN_LOSSES = (
    79.53620910644531, 50.799407958984375, 53.26505661010742,
    31.71601104736328, 49.4322509765625, 80.79585266113281,
    44.68871307373047, 37.24016571044922, 32.294837951660156,
    22.015527725219727)
GOLDEN_DRN_TRAIN_GRAPHS = "tests/golden_drn_train_graphs.npy"
# JAX package, the same validation pass through its CPU default, the
# composed graph build and the XLA-form conv:
# tests/test_torch_drn.py:jax_drn_eval(2000, 8, fused=False)
GOLDEN_DRN_COMPOSED_LOSS = 41.49879837036133
GOLDEN_DRN_COMPOSED_MET = "tests/golden_drn_composed_val_met.npy"
GOLDEN_DRN_COMPOSED_GRAPHS = "tests/golden_drn_composed_val_graphs.npy"
# mirror_gather on and off, one train-mode backward on the same graphs:
# every gradient within this much of the largest |gradient| (the port on the
# CPU at H=16: 1.4e-7, tests/test_torch_drn_composed.py)
DRN_MIRROR_ATOL = 1e-5
# The rule, fixed before any run on the card: a step whose graphs, and every
# earlier step's, equal the JAX digests is held to LOSS_RTOL; a later step
# trains on other graphs (near-ties, ROADMAP C; train-mode BatchNorm couples
# the batch's events) and is held to DRN_TRAIN_LATE_RTOL, set from the
# port's own CPU run against the same golden
# (tests/test_torch_drn_train.py:port_drn_resume_losses(10)).
# The port's CPU run took other graphs than the JAX package's from step 0
# (5 of 16 events), and its losses were then up to 0.131 from the golden
# (step 7): twice that, rounded up.
DRN_TRAIN_LATE_RTOL = 0.3
# Step 0 is also held to the port's own plain train step in f64 on the CPU,
# from the same weights and optimizer state and on the graphs the card
# built (injected in place of the graph build and the matching, so near-ties
# cannot move them): the loss within DRN_STEP_LOSS_RTOL, each gradient after
# the clip within DRN_STEP_GRAD_ATOL of its tensor's max |gradient|, each
# parameter after the AdamW update within DRN_STEP_PARAM_ATOL, and each
# BatchNorm buffer within DRN_STEP_BN_ATOL of its max.  Set before any run on
# the card, from the port's f32 plain step against the same f64 step on the
# CPU (first train batch at batch 4, drn_step_against_f64 on the CPU): loss
# 1.7e-5, gradients up to 1.7e-4 of their max (conv 0's lin1, whose
# BatchNorm statistics cancel; most tensors below 5e-5), parameters 2.7e-7,
# buffers 6.8e-7 of their max.  About ten times those readings (the
# parameters' seven times: AdamW moves them by about lr = 1e-3).  The f64 step
# runs the port's own code, which tests/test_torch_drn_train.py holds to the
# JAX package's train step on the CPU (loss, gradients, clip, AdamW with its
# weight decay, the BatchNorm update); this check holds the card's run of
# that code, kernels included, to it at the full batch.
DRN_STEP_LOSS_RTOL = 2e-4
DRN_STEP_GRAD_ATOL = 2e-3
DRN_STEP_PARAM_ATOL = 2e-6
DRN_STEP_BN_ATOL = 1e-5


def write_reference_checkpoint(params, bn_state, path: str,
                               epoch: int = 0) -> None:
    """Write GraphMET weights in the JAX package's layout (numpy trees, as
    ``params_to_jax`` gives them) as a reference ``.pth.tar``: a ``Net``
    state_dict (``graphnet.*``, torch ``[out, in]`` Linear weights, PyG
    EdgeConv's ``nn.0`` Linear, BatchNorm1d buffers) with ``epoch``,
    ``optim_dict`` and ``sched_dict``, as reference train.py:110-113 saves
    it; ``--from_torch`` reads it back."""
    import numpy as np
    import torch

    g, sd = "graphnet", {}

    def t(a):
        return torch.tensor(np.asarray(a))

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = t(np.asarray(p["w"]).T)
        sd[f"{prefix}.bias"] = t(p["b"])

    def bn(prefix, p, st):
        sd[f"{prefix}.weight"] = t(p["gamma"])
        sd[f"{prefix}.bias"] = t(p["beta"])
        sd[f"{prefix}.running_mean"] = t(st[0])
        sd[f"{prefix}.running_var"] = t(st[1])
        sd[f"{prefix}.num_batches_tracked"] = t(np.int64(st[2]))

    for name in ("embed_charge", "embed_pdgid", "embed_pv"):
        sd[f"{g}.{name}.weight"] = t(params[name]["w"])
    for name in ("embed_continuous", "embed_categorical", "encode_all"):
        lin(f"{g}.{name}.0", params[name])
    bn(f"{g}.bn_all", params["bn_all"], bn_state["bn_all"])
    for d, conv in enumerate(params["convs"]):
        lin(f"{g}.conv_continuous.{d}.0.nn.0", conv["edge"])
        bn(f"{g}.conv_continuous.{d}.1", conv["bn"], bn_state["convs"][d])
    lin(f"{g}.output.0", params["output"]["lin0"])
    lin(f"{g}.output.2", params["output"]["lin1"])
    torch.save({"epoch": epoch, "state_dict": sd,
                "optim_dict": {"state": {}, "param_groups": [
                    {"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8,
                     "weight_decay": 0.01, "params": []}]},
                "sched_dict": {"best": 1.0, "num_bad_epochs": 0,
                               "_last_lr": [1e-3]}}, path)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(f"{phase}: " + json.dumps(kv), flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bitwise_equal(a, b) -> bool:
    import torch

    # +0.0 turns -0.0 into +0.0, so only the sign of a zero is forgiven
    return torch.equal((a + 0.0).view(torch.int32), (b + 0.0).view(torch.int32))


def n_differ(a, b) -> int:
    import torch

    return int(((a + 0.0).view(torch.int32) != (b + 0.0).view(torch.int32)).sum())


def window_work(pos, mask, halo: int, r2: float):
    """(window pairs, adjacent pairs) with a real query row (``mask``): the
    predicates and the selections the data needs; padded rows' outputs are
    discarded by the caller.  The backward's count is the same with source
    and query swapped (the window and the predicate are symmetric)."""
    import torch
    from deepmetv2_tpu_torch.ops.window import adjacent

    B, N, _ = pos.shape
    i = torch.arange(N, device=pos.device)
    span = torch.clamp(i + halo, max=N - 1) - torch.clamp(i - halo, min=0) + 1
    pairs = int((span[None, :] * mask).sum())
    eta, phi = pos[..., 0], pos[..., 1]
    adj = 0
    for d in range(min(halo, N - 1) + 1):
        a = adjacent(eta[:, d:], phi[:, d:], eta[:, :N - d], phi[:, :N - d], r2)
        adj += int((a & mask[:, d:]).sum())            # query i + d
        if d:
            adj += int((a & mask[:, :N - d]).sum())    # query i
    return pairs, adj


def bound(nbytes: int, ops: int):
    """(bound ms, what bounds it, bytes ms, ops ms) on an H100 SXM."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


def window_bytes(pos, H: int, reads: int) -> int:
    """Bytes a window kernel must move: ``reads`` [B, N, H] inputs at the
    real rows only (a padded row's are never read), one whole [B, N, H]
    output (padded rows are written too) and ``pos``."""
    from deepmetv2_tpu_torch.ops.window import padded_rows

    B, N, _ = pos.shape
    real = int((~padded_rows(pos)).sum())
    return 4 * (reads * H * real + B * N * H + pos.numel())


def ptxas_table(log: str):
    """Per compiled kernel of a ``-Xptxas -v`` log: its name (demangled
    roughly: the function and its template arguments), registers and spill
    bytes (stores + loads)."""
    import re

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
                      r"(I\w*?EE)?", ln)
        if m:
            targs = re.findall(r"Li(\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(targs)}>" if targs else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "spill_bytes": spill})
            name = None
    return out


def chunk_counts(pos, halo: int, r2: float):
    """The window kernels' chunk visits: (kept by the prune,
    window_chunks_needed; every chunk of every block's window; blocks with
    a real row), for 32-row blocks and chunks."""
    from deepmetv2_tpu_torch.ops.window import window_chunks_needed

    B, N, _ = pos.shape
    needed = window_chunks_needed(pos, 32, 32, halo, r2)
    t0 = [32 * t for t in range(-(-N // 32))]
    per_event = sum(-(-(min(N, t + 32 + halo) - max(0, t - halo)) // 32)
                    for t in t0)
    return (int(needed.sum()), B * per_event,
            int(needed.any(-1).sum()))


def kernel_phase(device):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
        window_edgeconv_linear_cuda, window_max)
    from deepmetv2_tpu_torch.ops.window import (WindowGraph, padded_pos,
                                                padded_rows,
                                                window_edgeconv_linear,
                                                window_max_torch)
    from deepmetv2_tpu_torch.probes.window_breakdown import probe_inputs

    rng = np.random.default_rng(0)
    r2 = R ** 2
    inputs = probe_inputs(device)
    c_a, pos_a, halo = inputs["eval"]
    tc, tpos, _ = inputs["train"]
    B, N, H = c_a.shape

    def check(name, c, pos, halo):
        real = ~padded_rows(pos)
        m = window_max(c, pos, r2, halo)
        t = window_max_torch(c, pos, real, r2, halo)
        torch.cuda.synchronize()
        if not bitwise_equal(m, t):
            fail(f"window_max case {name}: {n_differ(m, t)} entries differ "
                 "from the plain version")
        if bool((m[~real] != float("-inf")).any()):
            fail(f"window_max case {name}: a padded row is not -inf")
        fin = torch.isfinite(t)
        return float((m[fin] - t[fin]).abs().max()) if fin.any() else 0.0

    # (a) evaluation shape: an eta-sorted synthetic batch (the probe's),
    # and the same through a pos view at an odd float offset (the kernels
    # read pos as float2; the wrapper copies such a view)
    mask_a = ~padded_rows(pos_a)
    errs = [check("a", c_a, pos_a, halo)]
    odd = torch.empty(pos_a.numel() + 1, device=device)[1:].view_as(pos_a)
    odd.copy_(pos_a)
    if not bitwise_equal(window_max(c_a, odd, r2, halo),
                         window_max(c_a, pos_a, r2, halo)):
        fail("window_max differs on a pos view at an odd float offset")

    # (b) clustered eta on a 0.1 lattice (pairs exactly on the radius
    # boundary), values rounded to 0.1 (exact ties), wide halo
    Bb = 8
    eta = np.sort(rng.choice([-4.0, 0.0, 4.0], size=(Bb, N))
                  + np.round(rng.normal(0, 0.3, (Bb, N)), 1), axis=1)
    phi_b = np.round(rng.uniform(-np.pi, np.pi, (Bb, N)), 1)
    pos_b = torch.as_tensor(np.stack([eta, phi_b], -1).astype(np.float32),
                            device=device)
    c_b = torch.as_tensor(np.round(rng.normal(size=(Bb, N, H)), 1)
                          .astype(np.float32), device=device)
    errs.append(check("b", c_b, pos_b, 192))

    # (c) padded nodes and empty events, through the whole EdgeConv wrapper
    nv = rng.integers(0, N, size=B)
    nv[::7] = 0                                      # empty padded events
    mask_c = mask_a & torch.as_tensor(
        np.arange(N)[None, :] < nv[:, None], device=device)
    pos_c = padded_pos(pos_a, mask_c)
    errs.append(check("c", c_a, pos_c, halo))
    x = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32),
                        device=device)
    w = torch.as_tensor(rng.normal(size=(2 * H, H)).astype(np.float32) * 0.1,
                        device=device)
    bias = torch.as_tensor(rng.normal(size=(H,)).astype(np.float32),
                           device=device)
    g = WindowGraph(pos_a, mask_c, r=R, halo=halo)
    with torch.no_grad():
        out_k = window_edgeconv_linear_cuda(x, g, w, bias)
        out_t = window_edgeconv_linear(x, g, w, bias)
    if not bitwise_equal(out_k, out_t):
        fail("window_edgeconv_linear_cuda differs from the plain version")
    if bool((out_k[~mask_c] != 0).any()):
        fail("window_edgeconv_linear_cuda is not 0 at padded nodes")

    # (d) the training shape's cell-ordered batch with its coordinates on a
    # 0.1 lattice: pairs exactly on the radius, and chunk boxes whose gap
    # squares to r2 or just past it, where the prune must keep or may drop
    tmask = ~padded_rows(tpos)
    pos_d = padded_pos(torch.round(tpos * 10) / 10, tmask)
    c_d = torch.as_tensor(rng.normal(size=(TRAIN_B, TRAIN_N, H))
                          .astype(np.float32), device=device)
    errs.append(check("d", c_d, pos_d, TRAIN_HALO))

    ms = cuda_ms(lambda: window_max(c_a, pos_a, r2, halo), 50)
    plain_ms = cuda_ms(lambda: window_max_torch(c_a, pos_a, mask_a, r2, halo),
                       5)
    pairs, adj = window_work(pos_a, mask_a, halo, r2)
    nbytes = window_bytes(pos_a, H, 1)      # c at real rows; m; pos
    ops = 6 * pairs + H * adj     # predicate: 2 sub, 2 mul, add, compare
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
    kept, chunks, blocks = chunk_counts(pos_a, halo, r2)

    # the training shape: cell order, halo 192, 8 events
    t_ms = cuda_ms(lambda: window_max(tc, tpos, r2, TRAIN_HALO), 50)
    t_pairs, t_adj = window_work(tpos, tmask, TRAIN_HALO, r2)
    t_bound = bound(window_bytes(tpos, H, 1), 6 * t_pairs + H * t_adj)
    t_kept, t_chunks, t_blocks = chunk_counts(tpos, TRAIN_HALO, r2)
    say("kernel", name="window_max_fwd", cases="a,b,c,d bitwise equal",
        shape=[B, N, H], halo=halo, real_rows=int(mask_a.sum()),
        ms=ms, plain_ms=plain_ms, kept_chunks=kept, window_chunks=chunks,
        blocks_with_real_rows=blocks,
        bytes=nbytes, window_pairs=pairs, adjacent_pairs=adj, fp32_ops=ops,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
        train_shape=[TRAIN_B, TRAIN_N, H], train_halo=TRAIN_HALO,
        train_real_rows=int(tmask.sum()), train_ms=t_ms,
        train_kept_chunks=t_kept, train_window_chunks=t_chunks,
        train_blocks_with_real_rows=t_blocks,
        train_window_pairs=t_pairs, train_adjacent_pairs=t_adj,
        train_bound_ms=t_bound[0])
    cases = {"a": (c_a, pos_a, halo), "b": (c_b, pos_b, 192),
             "c": (c_a, pos_c, halo), "d": (c_d, pos_d, TRAIN_HALO)}
    return cases, (x, g, w, bias), {
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by}


def kernel_bwd_phase(device, cases, edge_args):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
        window_edgeconv_linear_cuda, window_max, window_max_bwd)
    from deepmetv2_tpu_torch.ops.window import (padded_rows,
                                                window_edgeconv_linear,
                                                window_max_bwd_torch)
    from deepmetv2_tpu_torch.probes.window_breakdown import probe_inputs

    rng = np.random.default_rng(1)
    r2 = R ** 2
    errs, ties = [], {}
    for name, (c, pos, halo) in cases.items():
        m = window_max(c, pos, r2, halo)
        g = torch.as_tensor(rng.normal(size=tuple(c.shape)).astype(np.float32),
                            device=device)
        dk = window_max_bwd(c, pos, m, g, r2, halo)
        dt = window_max_bwd_torch(c, pos, m, g, r2, halo)
        torch.cuda.synchronize()
        if not bitwise_equal(dk, dt):
            fail(f"window_max_bwd case {name}: {n_differ(dk, dt)} entries "
                 "differ from the plain version")
        if bool((dk[padded_rows(pos)] != 0).any()):
            fail(f"window_max_bwd case {name}: a padded row is not 0")
        errs.append(float((dk - dt).abs().max()))
        # with g = 1 each source counts the queries whose max it equals: a
        # tie gives every tied source a full count, so the total exceeds
        # the number of finite maxima by the extra tied sources
        ones = window_max_bwd(c, pos, m, torch.ones_like(m), r2, halo)
        ties[name] = int(ones.double().sum().item()
                         - torch.isfinite(m).sum().item())
    if ties["b"] <= 0:
        fail("case b has no tied maxima: the tie rule was not exercised")

    # gradients of x, w and b through the EdgeConv wrapper (kernels) against
    # the plain path's autograd (no ties in these random values)
    x, g, w, bias = edge_args
    G = torch.as_tensor(rng.normal(size=tuple(x.shape)).astype(np.float32),
                        device=device)
    grads = []
    for fn in (window_edgeconv_linear_cuda, window_edgeconv_linear):
        args = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        (fn(args[0], g, args[1], args[2]) * G).sum().backward()
        grads.append([a.grad for a in args])
    grad_err = 0.0
    for name, k, t in zip(("x", "w", "b"), *grads):
        tol = GRAD_RTOL * t.abs() + GRAD_ATOL * float(t.abs().max())
        if not bool(((k - t).abs() <= tol).all()):
            fail(f"gradient of {name} through window_edgeconv_linear_cuda "
                 f"differs from the plain path by {float((k - t).abs().max())}")
        grad_err = max(grad_err, float((k - t).abs().max()))

    # the training shape: cell order, halo 192, B=8, N=2048, H=32
    c, pos, _ = probe_inputs(device)["train"]
    real = ~padded_rows(pos)
    H = c.shape[-1]
    m = window_max(c, pos, r2, TRAIN_HALO)
    gr = torch.as_tensor(rng.normal(size=tuple(c.shape)).astype(np.float32),
                         device=device) * real[..., None]   # 0 at padding
    ms = cuda_ms(lambda: window_max_bwd(c, pos, m, gr, r2, TRAIN_HALO), 50)
    plain_ms = cuda_ms(
        lambda: window_max_bwd_torch(c, pos, m, gr, r2, TRAIN_HALO), 3)
    pairs, adj = window_work(pos, real, TRAIN_HALO, r2)
    nbytes = window_bytes(pos, H, 3)      # c, m, g at real rows; dc; pos
    ops = 6 * pairs + 2 * H * adj   # predicate; compare and add per feature
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
    kept, chunks, blocks = chunk_counts(pos, TRAIN_HALO, r2)
    say("kernel_bwd", name="window_max_bwd", cases="a,b,c,d bitwise equal",
        extra_tied_sources=ties, edgeconv_grad_max_abs_err=grad_err,
        shape=[TRAIN_B, TRAIN_N, H], halo=TRAIN_HALO,
        real_rows=int(real.sum()), ms=ms, plain_ms=plain_ms,
        kept_chunks=kept, window_chunks=chunks, blocks_with_real_rows=blocks,
        bytes=nbytes, window_pairs=pairs, adjacent_pairs=adj, fp32_ops=ops,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops)
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def step_profile(step, reps: int = 5, cpu: bool = True):
    """(device ms per step, kernels per step, top kernels) of ``step``
    under torch.profiler (``cpu=False``: the device's activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        # a user annotation (e.g. "Optimizer.step#AdamW.step") spans kernels
        # that are listed themselves: counting it would count them twice
        if str(getattr(e, "device_type", "")).endswith("CUDA") and not \
                getattr(e, "is_user_annotation", False):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            kernels.append((us / reps / 1e3, e.count // reps, e.key[:48]))
    kernels.sort(reverse=True)
    return (sum(k[0] for k in kernels), sum(k[1] for k in kernels),
            [{"ms": k[0], "calls": k[1], "name": k[2]} for k in kernels[:8]])


def profile_phase(device, ck: str) -> None:
    """Where one evaluation step's (40 events, N=2048, halo 128, eta sort)
    and one train step's (8 events, N=2048, halo 192, cell order) device
    time goes: step time from CUDA events, device time by kernel from
    torch.profiler."""
    import dataclasses
    import itertools

    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.step import (make_eval_step,
                                                make_optimizer,
                                                make_train_step)

    cfg = load_run_config(ck)
    events = synthetic_events(2000, seed=42)
    ecfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, mode="window", window_halo=128))
    tcfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, mode="window", window_halo=TRAIN_HALO, presorted=True))
    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(tcfg, model)
    restore_checkpoint(os.path.join(ck, "best.ckpt"), model, opt)
    batch = to_device(next(iter(fetch_dataloader(events=events,
                                                 batch_size=40)["test"])),
                      device)
    eval_step = make_eval_step(ecfg)
    step_ms = cuda_ms(lambda: eval_step(model, batch), 20)
    dev_ms, n_k, top = step_profile(lambda: eval_step(model, batch))
    say("profile", step="eval", batch=[batch.batch_size, batch.max_nodes],
        step_ms=step_ms, device_ms=dev_ms, device_busy_share=dev_ms / step_ms,
        device_idle_share=1 - dev_ms / step_ms, kernels_per_step=n_k, top=top)

    ld = fetch_dataloader(events=events, batch_size=TRAIN_B,
                          presort_eta=True, presort_mode="cell")["train"]
    batch = to_device(next(itertools.islice(iter(ld), 1)), device)
    train_step = make_train_step(tcfg)
    step_ms = cuda_ms(lambda: train_step(model, opt, batch), 20)
    dev_ms, n_k, top = step_profile(lambda: train_step(model, opt, batch))
    say("profile", step="train", batch=[batch.batch_size, batch.max_nodes],
        step_ms=step_ms, device_ms=dev_ms, device_busy_share=dev_ms / step_ms,
        device_idle_share=1 - dev_ms / step_ms, kernels_per_step=n_k, top=top)


def train_resume_phase(device) -> None:
    """10 train steps from the committed JAX checkpoint, each loss held to
    GOLDEN_TRAIN_LOSSES (a lost AdamW count or moment shows at step 2),
    through the chained runner as chains of 8 and 2 (the first chain of
    each length runs eagerly: it warms up the graph that a third chain of
    that length would replay)."""
    import dataclasses
    import itertools

    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
    from deepmetv2_tpu_torch.train.chain import (make_chained_train_step,
                                                 stack_batches)
    from deepmetv2_tpu_torch.train.step import make_optimizer

    ck = os.path.join(HERE, "ckpts_syn")
    cfg = load_run_config(ck)
    cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, mode="window", window_halo=TRAIN_HALO, presorted=True))
    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(cfg, model)
    sched = ReduceLROnPlateau(lr=cfg.optim.lr)
    payload = restore_checkpoint(os.path.join(ck, "best.ckpt"), model, opt,
                                 sched)
    ld = fetch_dataloader(events=synthetic_events(2000, seed=42),
                          batch_size=TRAIN_B, presort_eta=True,
                          presort_mode="cell")["train"]
    hosts = list(itertools.islice(iter(ld), len(GOLDEN_TRAIN_LOSSES)))
    runner = make_chained_train_step(cfg)
    losses = []
    for chain in (hosts[:8], hosts[8:]):
        losses += runner(model, opt, to_device(stack_batches(chain),
                                               device)).tolist()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, GOLDEN_TRAIN_LOSSES)]
    say("train_resume", epoch=payload["epoch"], adam_count=payload["step"],
        sched_best=sched.best, chains=[8, 2], losses=losses, golden=GOLDEN_TRAIN_LOSSES,
        max_rel_err=max(rel))
    if not max(rel) <= LOSS_RTOL:
        fail(f"resumed train losses are not within {LOSS_RTOL} of the JAX "
             f"package's: {losses}")


FEED_LINE = "feed: resident, chain 8, CUDA graphs"   # the config's defaults


def check_feed_line(what: str, text: str) -> None:
    if FEED_LINE not in text.splitlines():
        fail(f"{what} did not print {FEED_LINE!r}")


def epoch_seconds(text: str):
    """Each "Training epoch" line's wall seconds."""
    return [float(ln.split("(")[1].split(" s,")[0]) for ln in
            text.splitlines() if ln.startswith("Training epoch")]


def train_phase(work: str):
    """The train CLI: 2 epochs into build/smoke/train, then a resume to 3
    epochs; exact launch counts; artifacts; the best checkpoint re-evaluated
    by the evaluate CLI.  Returns (forward launches, backward launches)."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import train as train_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)

    ck = os.path.join(work, "train")
    base = ["--synthetic", "2000", "--batch_size", str(TRAIN_B), "--ckpts", ck]
    steps, evals, convs = 200, 50, 2          # per epoch: 1600 / 8, 400 / 8
    fwd = bwd = 0
    for argv, epochs in ((["--epochs", "2"], 2),
                         (["--epochs", "3", "--restore_file", "last"], 1)):
        window_max.launches = window_max_bwd.launches = 0
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_cli.main(base + argv)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        text = out.getvalue()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("graph mode", "feed:", "Training epoch",
                                   "- Eval", "Restarting"))]
        say("train", argv=argv, seconds=sec, fwd_launches=window_max.launches,
            bwd_launches=window_max_bwd.launches,
            epoch_seconds=epoch_seconds(text), log=lines)
        if rc != 0:
            fail(f"train CLI {argv} exited {rc}")
        if f"graph mode: window (halo {TRAIN_HALO}, order cell)" not in text:
            fail(f"train CLI did not print halo {TRAIN_HALO}, order cell")
        check_feed_line("train CLI", text)
        want_f = epochs * (steps * convs + evals * convs)
        want_b = epochs * steps * convs
        if (window_max.launches, window_max_bwd.launches) != (want_f, want_b):
            fail(f"train CLI {argv}: launches forward {window_max.launches}, "
                 f"backward {window_max_bwd.launches}; want {want_f}, {want_b}")
        fwd += window_max.launches
        bwd += window_max_bwd.launches
    for f in ("loss.log", "metrics_val_best.json", "metrics_val_last.json",
              "best.resolutions", "last.resolutions", "best.ckpt", "last.ckpt",
              "config.json"):
        if not os.path.exists(os.path.join(ck, f)):
            fail(f"train CLI wrote no {f}")
    rows = [ln.split(",") for ln in open(os.path.join(ck, "loss.log"))
            if ln[:1].isdigit()]
    if [r[0] for r in rows] != ["1", "2", "3"] or not all(
            np.isfinite(float(v)) for r in rows for v in r[1:]):
        fail(f"loss.log rows are not epochs 1-3 with finite losses: {rows}")
    with open(os.path.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    ev = os.path.join(work, "train_eval")
    os.makedirs(ev)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(ck, f), ev)
    got = evaluate_cli.run(["--synthetic", "2000", "--ckpts", ev,
                            "--batch_size", str(TRAIN_B)])["loss"]
    rel = abs(got - best) / abs(best)
    say("train_reeval", metrics_val_best=best, evaluate_cli=got, rel_err=rel,
        loss_log=[",".join(r).strip() for r in rows])
    if not rel <= REEVAL_RTOL:
        fail(f"evaluate CLI gives {got} on the train CLI's best.ckpt, not "
             f"within {REEVAL_RTOL} of its metrics_val_best.json {best}")
    return fwd, bwd


def drn_model(device):
    """(DRN with ckpts_syn_drn/best.ckpt, its run config)."""
    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.models.drn import DRN
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint

    ck = os.path.join(HERE, DRN_CKPTS)
    cfg = load_run_config(ck)
    payload = load_checkpoint(os.path.join(ck, "best.ckpt"))
    model = DRN(cfg.drn, device=device)
    return model.params_from_jax(payload["params"],
                                 payload["bn_state"]).eval(), cfg


def drn_val_loader(cfg, batch_size: int):
    """The validation loader of synthetic 2000 (seed 42, split 0.2), as the
    evaluate CLI builds it."""
    from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events

    return fetch_dataloader(events=synthetic_events(2000, seed=42),
                            batch_size=batch_size, validation_split=0.2,
                            buckets=cfg.data.node_buckets)["test"]


def drn_features(model, batch):
    """The DRN's round-1 features ``[B, N, H]`` of a batch (inputnet)."""
    import torch

    x = torch.cat([batch.x_cont, batch.x_cat.to(batch.x_cont.dtype)], dim=-1)
    with torch.no_grad():
        return model.inputnet(model.datanorm * x, final_act=True)


def drn_graph_digests(rounds):
    """Per event, one 64-bit digest per DRN round of the round's discrete
    decisions over its real rows: the neighbour lists (each sorted, masked
    slots last) and the matching's cluster and partner.  ``rounds`` holds,
    per round, numpy arrays (mask [B, N], idx [B, N, K], slot mask [B, N,
    K], cluster [B, N], partner [B, N]); returns ``[B, rounds]`` uint64.
    The JAX package's digests of the same events are GOLDEN_DRN_GRAPHS."""
    import hashlib

    import numpy as np

    out = np.zeros((rounds[0][0].shape[0], len(rounds)), np.uint64)
    for r, (mask, idx, nmask, cluster, partner) in enumerate(rounds):
        lists = np.sort(np.where(nmask, idx, np.iinfo(np.int32).max), axis=-1)
        for b in range(mask.shape[0]):
            m = mask[b].astype(bool)
            d = hashlib.blake2b(digest_size=8)
            for a in (lists[b][m], cluster[b][m], partner[b][m]):
                d.update(np.ascontiguousarray(a, dtype=np.int32).tobytes())
            out[b, r] = int.from_bytes(d.digest(), "little")
    return out


def drn_eval_pass(model, loader, device, **forces):
    """The DRN's validation pass as the evaluate CLI takes it, with what the
    CLI does not return: ``(losses, met, graphs)``, the per-batch losses, the
    cartesian MET estimate of every event ``[n, 2]`` in the loader's order
    and its per-round graph digests ``[n, rounds]``.  ``forces``
    (``graph_force``, ``conv_force``) go to ``drn_net_apply``."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.models.drn import drn_net_apply
    from deepmetv2_tpu_torch.train.loss import drn_loss_fn, drn_met_vector

    head = model.cfg.head
    losses, mets, graphs = [], [], []
    for host, ids in zip(loader, loader._batches):
        batch = to_device(host, device)
        diag = {}
        with torch.no_grad():
            pred = drn_net_apply(model.eval(), batch, diag, **forces)
        losses.append(float(drn_loss_fn(pred, batch, head)))
        mets.append(drn_met_vector(pred, head)[:len(ids)].cpu().numpy())
        rounds = [[t.cpu().numpy() for t in (m, nbr.idx, nbr.mask, c, p)]
                  for m, nbr, c, p in diag["rounds"]]
        graphs.append(drn_graph_digests(rounds)[:len(ids)])
    return losses, np.concatenate(mets), np.concatenate(graphs)


def knn_bound(mask, H: int, cap: int = 0, rel: bool = False):
    """The knn kernels' bound from this run's mask: the distance products
    the data needs, one multiply and one add per feature for each pair of
    real nodes of an event, each pair once (d² is symmetric), plus the
    squared norms; bytes of h, mask, t and sq (each read or written once),
    plus idx, d2v and the relation for the extraction."""
    B, N = mask.shape
    n = mask.sum(dim=1).double()
    ops = int(round(float((H * n * (n - 1) + 2 * H * n).sum())))
    nbytes = 4 * B * N * H + B * N + 8 * B * N
    if cap:
        nbytes += 8 * B * N * cap + (B * N * N if rel else 0)
    return bound(nbytes, ops)


# knn_kth / knn_extract ms of the kernels' first design (every row against
# every padded source, one dot product per lane) at B=40, H=64 on the same
# features, on an H100 80GB HBM3 at 700 W (PERF.md's kernel table), printed
# beside this run's
KNN_FIRST_DESIGN_MS = {2048: (5.29, 5.59), 1536: (3.04, 3.23)}


def kernel_knn_phase(device, model, batch):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_extract, knn_kth
    from deepmetv2_tpu_torch.ops.dyn_graph import (build_dyn_graph,
                                                   cut_matching,
                                                   dense_matching)
    from deepmetv2_tpu_torch.ops.knn_und import (knn_extract_torch,
                                                 knn_kth_torch)

    k, cap = DRN_K, DRN_CAP

    def check(name, h, mask):
        t, sq = knn_kth(h, mask, k)
        tp, sqp = knn_kth_torch(h, mask, k)
        out = knn_extract(h, mask, tp, sqp, cap, True)
        plain = knn_extract_torch(h, mask, tp, sqp, cap, True)
        torch.cuda.synchronize()
        for what, a, b in (("thresholds", t, tp), ("squared norms", sq, sqp)):
            if not bitwise_equal(a, b):
                fail(f"knn_kth case {name}: {n_differ(a, b)} {what} differ "
                     "from the plain version")
        for what, a, b in zip(("idx", "d2v", "rel"), out, plain):
            if not torch.equal(a, b):
                fail(f"knn_extract case {name}: {what} differs from the "
                     f"plain version in {int((a != b).sum())} entries")
        pad = ~mask
        if not (bool(torch.isposinf(t[pad]).all())
                and bool((out[0][pad] == 0).all())
                and bool(torch.isposinf(out[1][pad]).all())
                and not bool(out[2][pad].any())):
            fail(f"knn case {name}: a padded query row is not t=+inf, "
                 "empty slots and a zero relation row")
        for a, b in ((t, tp), (out[1], plain[1])):
            fin = torch.isfinite(b)
            if fin.any():
                errs.append(float((a[fin] - b[fin]).abs().max()))
        return t, out

    errs = []
    rng = np.random.default_rng(3)
    # (a) the DRN's round-1 features of the first evaluation batch
    h_a = drn_features(model, batch)
    mask_a = batch.mask
    B, N, H = h_a.shape
    t_a, (_, d2v_a, rel_a) = check("a", h_a, mask_a)
    deg = rel_a.sum(-1)
    cap_rows = int(((deg > cap) & mask_a).sum())
    # (b) lattice features: many exactly equal distances
    h_b = torch.as_tensor(rng.integers(-2, 3, size=(4, 1024, 16)),
                          dtype=torch.float32, device=device)
    mask_b = torch.ones(4, 1024, dtype=torch.bool, device=device)
    mask_b[1, 700:] = False
    _, (_, d2v_b, _) = check("b", h_b, mask_b)
    fin = torch.isfinite(d2v_b[..., 1:])
    ties = int(((d2v_b[..., 1:] == d2v_b[..., :-1]) & fin).sum())
    if ties == 0:
        fail("knn case b has no equal distances: the tie rule was not "
             "exercised")
    # (c) padded rows, an empty event and a 3-node event at N=1536
    h_c = torch.as_tensor(rng.normal(size=(8, 1536, H)), dtype=torch.float32,
                          device=device)
    nv = rng.integers(0, 1536, size=8)
    nv[0], nv[1] = 0, 3
    mask_c = torch.as_tensor(np.arange(1536)[None, :] < nv[:, None],
                             device=device)
    t_c, _ = check("c", h_c, mask_c)
    if not bool(torch.isinf(t_c[1]).all()):
        fail("knn case c: a 3-node event has a finite k-th distance")
    # (d) scattered masks (about 60 % valid, random gaps) at N=2048, at a
    # size that is no multiple of the kernels' row and source tiles, and at
    # a width that is no multiple of a float4; event 0 empty, event 1
    # sparse, event 2 a hub: its first real node at the origin, the others
    # on a shell around it, so every node relates to it (a relation row
    # past the extraction's member list)
    scattered, hub_deg = 0, []
    for bd, nd, hd in ((8, 2048, H), (6, 1003, H), (4, 1003, 13)):
        h_d = torch.as_tensor(rng.normal(size=(bd, nd, hd)),
                              dtype=torch.float32, device=device)
        mask_d = torch.as_tensor(rng.random((bd, nd)) < 0.6, device=device)
        mask_d[0] = False
        mask_d[1, :] = False
        mask_d[1, ::97] = True           # a sparse event: few, far apart
        r = torch.as_tensor(rng.uniform(1.0, 2.0, size=(nd, 1)),
                            dtype=torch.float32, device=device)
        h_d[2] = h_d[2] / h_d[2].norm(dim=-1, keepdim=True) * r
        hub = int(torch.nonzero(mask_d[2])[0, 0])
        h_d[2, hub] = 0.0
        _, (_, _, rel_d) = check(f"d ({bd}, {nd}, {hd})", h_d, mask_d)
        scattered += int(mask_d.sum())
        hub_deg.append(int(rel_d[2, hub].sum()))
    if min(hub_deg) <= 64:
        fail(f"knn case d: the hubs relate to {hub_deg} nodes; a row past "
             "the extraction's 64-member list was not exercised")
    # (e) the large buckets, N=4096 and N=8192 at B=2 (fewer rows per
    # block), normal features, a 90 % mask: bitwise as above; the graph
    # build hands the extraction's relation over (at 8192 the matching's
    # weights are built in column tiles), and the matching pairs only
    # real nodes related in it, each the other's partner
    large = {}
    for ne in (4096, 8192):
        h_e = torch.as_tensor(rng.normal(size=(2, ne, H)), dtype=torch.float32,
                              device=device)
        mask_e = torch.as_tensor(rng.random((2, ne)) < 0.9, device=device)
        _, (_, _, rel_e) = check(f"e ({ne})", h_e, mask_e)
        g = build_dyn_graph(h_e, mask_e, k=k, cap=cap)
        if g.rel is None or not torch.equal(g.rel, rel_e):
            fail(f"knn case e ({ne}): the graph build does not hand over the "
                 "extraction's relation")
        hp = torch.as_tensor(rng.normal(size=(2, ne, H)), dtype=torch.float32,
                             device=device)
        _, partner = cut_matching(g, hp, mask_e)
        iota = torch.arange(ne, device=device).expand(2, ne)
        paired = partner != iota
        if not (torch.equal(torch.gather(partner, 1, partner), iota)
                and bool(torch.gather(rel_e, 2, partner[..., None].long())
                         [..., 0][paired].all())
                and not bool(paired[~mask_e].any())
                and bool(paired.any())):
            fail(f"knn case e ({ne}): the matching pairs nodes outside the "
                 "relation, or not mutually, or none")
        large[ne] = {"rel_pairs": int(rel_e.sum()),
                     "paired": int(paired.sum()),
                     "dense": dense_matching(2, ne)}
        del g, h_e, hp, rel_e

    times = {}
    for n in (N, 1536):
        h, m = h_a[:, :n].contiguous(), mask_a[:, :n].contiguous()
        t, sq = knn_kth(h, m, k)
        kb, eb = knn_bound(m, H), knn_bound(m, H, cap, True)
        times[n] = dict(
            kth_ms=cuda_ms(lambda: knn_kth(h, m, k), 20),
            extract_ms=cuda_ms(lambda: knn_extract(h, m, t, sq, cap, True),
                               20),
            kth_plain_ms=cuda_ms(lambda: knn_kth_torch(h, m, k), 2),
            extract_plain_ms=cuda_ms(
                lambda: knn_extract_torch(h, m, t, sq, cap, True), 2),
            first_design_ms=KNN_FIRST_DESIGN_MS[n],
            real_rows=int(m.sum()), kth_bound=kb, extract_bound=eb)
    say("kernel_knn", names=["knn_kth", "knn_extract"],
        cases="a,b,c,d,e bitwise equal (t, sq, idx, d2v, rel); padded rows "
              "t=+inf, empty slots, zero rel; e: the tiled matching's "
              "relation is rel", shape=[B, N, H],
        k=k, cap=cap, real_rows=int(mask_a.sum()),
        rows_past_cap_a=cap_rows, max_degree_a=int(deg[mask_a].max()),
        equal_adjacent_slots_b=ties, real_rows_d=scattered,
        hub_degree_d=hub_deg, large_e=large, times=times)
    tk, te = times[N], times[N]
    return (h_a, t_a), [
        {"max_abs_err": max(errs), "ms": tk["kth_ms"],
         "plain_ms": tk["kth_plain_ms"], "bound_ms": tk["kth_bound"][0],
         "bound_by": tk["kth_bound"][1]},
        {"max_abs_err": max(errs), "ms": te["extract_ms"],
         "plain_ms": te["extract_plain_ms"],
         "bound_ms": te["extract_bound"][0],
         "bound_by": te["extract_bound"][1]}]


# edge_mlp_fwd / edge_mlp_bwd ms of the kernels' first design (one warp per
# node, the first layer per edge, weight gradients folded through shared
# memory) at the shapes this script times them, on an H100 80GB HBM3 at
# 700 W (PERF.md's kernel table), printed beside this run's
EDGE_MLP_FIRST_DESIGN_MS = (1.102, 2.458)


def close_to_f64(name: str, got, ref) -> float:
    """``got`` (f32, on the card) against ``ref`` (the plain product in
    f64): within GRAD_RTOL·|ref| + GRAD_ATOL·max|ref|; returns the largest
    difference."""
    d = (got.double() - ref).abs()
    tol = GRAD_RTOL * ref.abs() + GRAD_ATOL * float(ref.abs().max())
    if not bool((d <= tol).all()):
        fail(f"{name} differs from its plain product in f64 by "
             f"{float(d.max())} ({int((d > tol).sum())} entries past the "
             "tolerance)")
    return float(d.max())


def kernel_edge_mlp_phase(device, model, h, mask):
    """edge_mlp_fwd against its plain version on the DRN's round-1 graph of
    the evaluation batch (padded query rows have no valid slot), for each
    aggregation, its first layer's kernel against the plain product, and
    its time and bound at that shape."""
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import (edge_mlp_fwd,
                                                       edge_mlp_proj)
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph
    from deepmetv2_tpu_torch.ops.edge_mlp import edge_mlp_fwd_torch, proj_torch

    nbr, _, _ = knn_und_graph(h, mask, k=DRN_K, cap=DRN_CAP)
    mlp = model.convs[0].mlp.params()
    H = h.shape[-1]
    w0, b0 = mlp["lin0"]["w"].detach(), mlp["lin0"]["b"].detach()
    w_diff = w0[H:]
    w1, b1 = mlp["lin1"]["w"].detach(), mlp["lin1"]["b"].detach()
    F1, H2 = w1.shape
    with torch.no_grad():
        a = torch.matmul(h, w0[:H] - w_diff) + b0
    args = (a, h, nbr, w_diff, w1, b1)
    errs, empty = [], int((~nbr.mask.any(-1)).sum())
    for aggr in ("add", "mean", "max"):
        with torch.no_grad():
            got = edge_mlp_fwd(*args, aggr)
            want = edge_mlp_fwd_torch(*args, aggr)
        torch.cuda.synchronize()
        for what, k_, p_ in zip(("agg0", "agg1", "stats"), got, want):
            if p_ is None:
                continue
            fin = torch.isfinite(p_)
            if not torch.equal(torch.isfinite(k_), fin) or not torch.equal(
                    k_[~fin], p_[~fin]):
                fail(f"edge_mlp_fwd {aggr} {what}: the empty rows' "
                     "sentinels differ from the plain version")
            d = (k_[fin] - p_[fin]).abs()
            tol = (GRAD_RTOL * p_[fin].abs()
                   + GRAD_ATOL * float(p_[fin].abs().max()))
            if not bool((d <= tol).all()):
                fail(f"edge_mlp_fwd {aggr} {what} differs from the plain "
                     f"version by {float(d.max())}")
            errs.append(float(d.max()))
    # the per-node first layer's kernel against its plain product in f64
    with torch.no_grad():
        P = edge_mlp_proj(h, w_diff)
    proj_err = close_to_f64("edge_mlp_proj", P,
                            proj_torch(h.double(), w_diff.double()))
    B, N, K = nbr.mask.shape
    edges, nodes = int(nbr.mask.sum()), int(mask.sum())
    with torch.no_grad():
        ms = cuda_ms(lambda: edge_mlp_fwd(*args, "add"), 20)
        plain_ms = cuda_ms(lambda: edge_mlp_fwd_torch(*args, "add"), 3)
    nbytes = 4 * (a.numel() + h.numel() + nbr.idx.numel() + w_diff.numel()
                  + w1.numel() + b1.numel() + B * N * H2 + 2 * H2) \
        + nbr.mask.numel()
    # what these inputs need: the first layer once per real node, the
    # second once per valid edge
    ops = 2 * H * F1 * nodes + 2 * F1 * H2 * edges
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
    say("kernel_edge_mlp", name="edge_mlp_fwd",
        cases="add,mean,max within rtol 1e-5 + 2e-6 max|plain|; the "
              "projection x.W_diff against its plain product in f64",
        max_abs_err=max(errs), proj_max_abs_err=proj_err,
        shape=[B, N, K, H, F1, H2], real_nodes=nodes,
        valid_edges=edges, empty_rows=empty, ms=ms, plain_ms=plain_ms,
        bytes=nbytes, fp32_ops=ops, bound_bytes_ms=t_bytes,
        bound_ops_ms=t_ops, first_design_ms=EDGE_MLP_FIRST_DESIGN_MS[0])
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def drn_counters():
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import edge_mlp_fwd
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_extract, knn_kth

    return {"knn_kth": knn_kth, "knn_extract": knn_extract,
            "edge_mlp_fwd": edge_mlp_fwd}


def evaluate_drn_phase(device, work: str, model, cfg):
    """The evaluate CLI with --model drn; returns the launches per kernel.
    A second pass over the same batches (drn_eval_pass) must give the CLI's
    loss, and holds every event to the JAX package's fused path: an event
    may miss DRN_EVENT_RTOL only where its graph decisions differ from the
    JAX package's (near-ties, ROADMAP C), such events must stay few, and
    the loss over the events with equal graphs must equal the JAX loss
    over the same events within DRN_KEPT_RTOL."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import window_max

    ck = ckpt_copy(work, "drn", DRN_CKPTS)
    counters = drn_counters()
    for fn in list(counters.values()) + [window_max]:
        fn.launches = 0
    t = time.perf_counter()
    loss = evaluate_cli.run(["--model", "drn", "--synthetic", "2000",
                             "--batch_size", "8", "--ckpts", ck])["loss"]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters.items()}

    ld = drn_val_loader(cfg, 8)
    losses, met, graphs = drn_eval_pass(model, ld, device)
    pass_loss = float(np.mean(np.asarray(losses, np.float64)))
    cli_rel = abs(loss - pass_loss) / pass_loss
    drn_golden_rule(
        "evaluate_drn", ld, losses, met, graphs, GOLDEN_DRN_MET,
        GOLDEN_DRN_GRAPHS, loss=loss, golden=GOLDEN_DRN_LOSS,
        rel_err=abs(loss - GOLDEN_DRN_LOSS) / GOLDEN_DRN_LOSS,
        loss_first_design=DRN_LOSS_FIRST_DESIGN,
        same_as_first_design=loss == DRN_LOSS_FIRST_DESIGN,
        jax_tpu_run_loss_not_a_gate=JAX_TPU_DRN_LOSS, launches=launches,
        window_max_launches=window_max.launches, seconds=sec,
        checked_pass_loss=pass_loss, cli_rel_err=cli_rel)
    want = 2 * len(ld)
    if launches != {k: want for k in counters} or window_max.launches:
        fail(f"DRN evaluate launched {launches} and window_max "
             f"{window_max.launches} times; want {want} each and 0")
    if not cli_rel <= DRN_CLI_RTOL:
        fail(f"DRN evaluate CLI loss {loss} is {cli_rel} from the checked "
             f"pass's {pass_loss}, not within {DRN_CLI_RTOL}")
    return launches


def predict_drn_phase(work: str):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.cli import predict as predict_cli

    counters = drn_counters()
    for fn in counters.values():
        fn.launches = 0
    out = os.path.join(work, "pred_drn.npz")
    t = time.perf_counter()
    predict_cli.main(["--model", "drn", "--synthetic", "2000", "--ckpts",
                      os.path.join(work, "drn"), "--out", out])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters.items()}
    z = np.load(out)
    say("predict_drn", events=int(len(z["met"])), launches=launches,
        seconds=sec, keys=sorted(z.files), met_mean=float(np.mean(z["met"])))
    if len(z["met"]) != 2000 or not np.array_equal(z["event_index"],
                                                   np.arange(2000)):
        fail("DRN predict did not return 2000 events in input order")
    if not np.all(np.isfinite(z["met"])) or "weights" in z.files:
        fail("DRN predict returned non-finite MET or per-candidate weights")
    if launches != {k: 2 * 50 for k in counters}:
        fail(f"DRN predict launched {launches}; want 100 of each")
    return launches


def drn_profile(device, model, cfg) -> None:
    """One DRN evaluation step (40 events, N=2048): step time from CUDA
    events, device time by kernel from torch.profiler."""
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.train.step import make_drn_eval_step

    batch = to_device(next(iter(drn_val_loader(cfg, DRN_B))), device)
    step = make_drn_eval_step(cfg)
    step_ms = cuda_ms(lambda: step(model, batch), 10)
    dev_ms, n_k, top = step_profile(lambda: step(model, batch), reps=3)
    say("profile", step="drn_eval", batch=[batch.batch_size, batch.max_nodes],
        step_ms=step_ms, device_ms=dev_ms, device_busy_share=dev_ms / step_ms,
        device_idle_share=1 - dev_ms / step_ms, kernels_per_step=n_k, top=top)


def near_tie_free(h, mask, sign: float):
    """``[B, N, H2]`` True where the row's max (sign 1) or min (sign −1) of
    the messages ``h [B, N, K, H2]`` over its valid slots is clear: every
    message not equal to it lies more than 1e-5·(1 + |max|) beyond it.
    Equal messages (the same gathered row, or saturated elu) are equal in
    any precision and share the cotangent evenly; where a message lies
    within the margin, the kernel in f32 and the reference in f64 may
    pick different slots, so a test cotangent is set to 0 there."""
    import torch

    v = torch.where(mask[..., None], sign * h, torch.full_like(h, -float("inf")))
    top = v.max(dim=2).values
    below = torch.where(v < top[:, :, None], v,
                        torch.full_like(v, -float("inf"))).max(dim=2).values
    return ~(top - below <= 1e-5 * (1.0 + top.abs()))


def check_reverse_index(case: str, nbr) -> int:
    """The reverse-index kernels against reverse_slots on ``nbr``: equal
    offsets, and equal order over each event's valid slots; returns the
    valid slots."""
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import reverse_index
    from deepmetv2_tpu_torch.ops.edge_mlp import reverse_slots

    order, offsets = reverse_index(nbr)
    want_order, want_offsets = reverse_slots(nbr)
    torch.cuda.synchronize()
    B, NK = order.shape
    used = (torch.arange(NK, device=order.device)[None, :]
            < want_offsets[:, -1:])
    if not torch.equal(offsets, want_offsets) or not torch.equal(
            order[used], want_order[used]):
        fail(f"reverse_index case {case}: differs from reverse_slots")
    return int(want_offsets[:, -1].sum())


def check_edge_mlp_bwd(case: str, a, x, nbr, w_diff, w1, b1, aggr, g0, g1,
                       gst):
    """The backward kernel (tie references from its own forward) against
    edge_mlp_bwd_torch evaluated in f64 on the same inputs: every gradient
    within GRAD_RTOL·|ref| + GRAD_ATOL·max|ref|.  The reference is f64
    because the weight gradients sum 10⁵–10⁶ terms of either sign: the
    f32 plain version's own sums (one long GEMM reduction) are further
    from the exact value than the kernel's, so the two f32 results can
    differ by more than the tolerance while each is close to it; the f32
    plain version's distance is reported beside.  Returns (max abs error,
    the kernel's gradients, {name: [kernel, f32 plain] max abs error})."""
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import edge_mlp_bwd, edge_mlp_fwd
    from deepmetv2_tpu_torch.ops.edge_mlp import (edge_mlp_bwd_torch,
                                                  edge_mlp_fwd_torch)

    def plain(dtype):
        t = [v if v is None else v.to(dtype)
             for v in (a, x, w_diff, w1, b1, g0, g1, gst)]
        p0, p1, _ = edge_mlp_fwd_torch(t[0], t[1], nbr, t[2], t[3], t[4], aggr)
        return edge_mlp_bwd_torch(t[0], t[1], nbr, t[2], t[3], t[4], aggr, p0,
                                  p1, t[5], t[6], t[7])

    with torch.no_grad():
        k0, k1, _ = edge_mlp_fwd(a, x, nbr, w_diff, w1, b1, aggr)
        got = edge_mlp_bwd(a, x, nbr, w_diff, w1, b1, aggr, k0, k1, g0, g1,
                           gst)
        ref = plain(torch.float64)
        p32 = plain(torch.float32)
    torch.cuda.synchronize()
    err, info = 0.0, {}
    for name, k_, r_, p_ in zip(ref._fields, got, ref, p32):
        d = (k_.double() - r_).abs()
        tol = GRAD_RTOL * r_.abs() + GRAD_ATOL * float(r_.abs().max())
        info[name] = [float(d.max()), float((p_.double() - r_).abs().max())]
        if not bool((d <= tol).all()):
            fail(f"edge_mlp_bwd case {case} {aggr} {name}: differs from the "
                 f"plain version in f64 by {float(d.max())} "
                 f"({int((d > tol).sum())} entries past the tolerance; the "
                 f"f32 plain version's distance {info[name][1]})")
        err = max(err, float(d.max()))
    return err, got, info


def train_batch_features(model, device):
    """The DRN's first train batch of synthetic 2000 at batch 16 and the
    round-1 cotangents of a real train-mode loss: ``(batch, h, nbr, g0,
    gst)`` with h the round-1 features and nbr its graph, g0 and gst the
    cotangents the round-1 EdgeMLP backward receives (the model is a copy,
    in train mode, so its weights and buffers stay as they are)."""
    import copy
    import itertools
    from unittest import mock

    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.data.batching import Neighborhood
    from deepmetv2_tpu_torch.models.drn import drn_net_apply
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import EdgeMLP
    from deepmetv2_tpu_torch.train.loss import drn_loss_fn

    ld = fetch_dataloader(events=synthetic_events(2000, seed=42),
                          batch_size=DRN_TRAIN_B)["train"]
    batch = to_device(next(itertools.islice(iter(ld), 1)), device)
    m = copy.deepcopy(model).train()
    calls = []
    orig = EdgeMLP.backward

    def recorded(ctx, g0, g1, gst):
        _, x, _, _, _, idx, mask = ctx.saved_tensors[:7]
        calls.append((x, Neighborhood(idx, mask), g0, gst))
        return orig(ctx, g0, g1, gst)

    loss = drn_loss_fn(drn_net_apply(m, batch), batch, m.cfg.head)
    with mock.patch.object(EdgeMLP, "backward", staticmethod(recorded)):
        loss.backward()
    # the rounds' backwards run last round first
    x, nbr, g0, gst = calls[-1]
    return batch, x.detach(), nbr, g0, gst


def kernel_edge_mlp_bwd_phase(device, model):
    """edge_mlp_bwd against its plain version (in f64, check_edge_mlp_bwd)
    on (a) the DRN's round-1
    features of a train batch (B=16, N=2048) with the cotangents of a real
    train-mode loss, (b) rows of 16 repeated prototypes (exact ties: the
    max's cotangent is shared evenly), (c) empty rows and padded events at
    N=1536, (d) a list cut by want_mirror, for add, mean and max; two
    launches bitwise equal; the conv's parameter gradients against autograd
    of the plain path; the kernel's time at (a)."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.data.batching import Neighborhood
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import (edge_mlp_bwd,
                                                       edge_mlp_conv,
                                                       edge_mlp_fwd,
                                                       edge_mlp_node_grads)
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph
    from deepmetv2_tpu_torch.ops.dyn_graph import build_dyn_graph
    from deepmetv2_tpu_torch.ops.edge_mlp import (bn_combine,
                                                  edge_mlp_bwd_torch,
                                                  edge_mlp_fwd_torch,
                                                  messages_torch,
                                                  node_grads_torch)

    rng = np.random.default_rng(11)
    mlp = {k: {n: v.detach() for n, v in d.items()}
           for k, d in model.convs[0].mlp.params().items()}
    w0, b0 = mlp["lin0"]["w"], mlp["lin0"]["b"]
    w1, b1 = mlp["lin1"]["w"], mlp["lin1"]["b"]
    H = w0.shape[0] // 2
    w_diff = w0[H:]
    F1, H2 = w1.shape

    def node_a(x):
        with torch.no_grad():
            return torch.matmul(x, w0[:H] - w_diff) + b0

    def run_case(case, x, nbr, g0, gst):
        a = node_a(x)
        out = {}
        for aggr in ("add", "mean", "max"):
            gg0, gg1 = g0, None
            if aggr == "max":
                with torch.no_grad():
                    h = messages_torch(*(t.double() for t in (a, x)), nbr,
                                       *(t.double() for t in (w_diff, w1, b1))
                                       )[-1]
                    m = nbr.mask[..., None]
                    top = torch.where(m, h, torch.full_like(h, -float("inf")))
                    top = top.max(dim=2).values
                gg0 = torch.where(near_tie_free(h, nbr.mask, 1.0), g0,
                                  torch.zeros_like(g0))
                gg1 = torch.where(near_tie_free(h, nbr.mask, -1.0),
                                  -0.5 * g0, torch.zeros_like(g0))
                tied = ((h == top[:, :, None]) & m).sum(2)
                out["tied_rows_max"] = int((tied > 1).sum())
                out["zeroed_near_ties"] = int((gg0 == 0).sum()
                                              - (g0 == 0).sum())
                del h
            err, got, out[aggr + "_err_kernel_plain32"] = check_edge_mlp_bwd(
                case, a, x, nbr, w_diff, w1, b1, aggr, gg0, gg1, gst)
            out[aggr] = err
        return a, out

    errs, info = [], {}
    # (a) the DRN's round-1 features of a train batch, real cotangents
    batch, h_a, nbr_a, g0_a, gst_a = train_batch_features(model, device)
    a_a, info["a"] = run_case("a", h_a, nbr_a, g0_a, gst_a)
    errs += [v for k, v in info["a"].items() if k in ("add", "mean", "max")]
    B, N, K = nbr_a.mask.shape
    # (b) 16 prototype rows: many slots of a row carry the same message
    Bb, Nb = 4, 1024
    proto = torch.as_tensor(rng.normal(size=(16, H)).astype(np.float32),
                            device=device)
    x_b = proto[torch.as_tensor(rng.integers(0, 16, size=(Bb, Nb)),
                                device=device)]
    x_b = x_b + torch.as_tensor(rng.integers(0, 2, size=(Bb, Nb, 1)) * 0.5,
                                dtype=torch.float32, device=device)
    mask_b = torch.ones(Bb, Nb, dtype=torch.bool, device=device)
    nbr_b, _, _ = knn_und_graph(x_b, mask_b, k=DRN_K, cap=DRN_CAP)
    g_b = torch.as_tensor(rng.normal(size=(Bb, Nb, H2)).astype(np.float32),
                          device=device)
    gst_b = torch.as_tensor(rng.normal(size=(2, H2)).astype(np.float32) * 1e-3,
                            device=device)
    _, info["b"] = run_case("b", x_b, nbr_b, g_b, gst_b)
    errs += [info["b"][k] for k in ("add", "mean", "max")]
    if info["b"]["tied_rows_max"] == 0:
        fail("edge_mlp_bwd case b has no tied maxima: the even split was "
             "not exercised")
    # (c) empty rows and padded events at N=1536
    Nc = 1536
    x_c = torch.as_tensor(rng.normal(size=(8, Nc, H)).astype(np.float32),
                          device=device)
    nv = rng.integers(0, Nc, size=8)
    nv[0], nv[1] = 0, 3
    mask_c = torch.as_tensor(np.arange(Nc)[None, :] < nv[:, None],
                             device=device)
    nbr_c, _, _ = knn_und_graph(x_c, mask_c, k=DRN_K, cap=DRN_CAP)
    g_c = torch.as_tensor(rng.normal(size=(8, Nc, H2)).astype(np.float32),
                          device=device)
    _, info["c"] = run_case("c", x_c, nbr_c, g_c, gst_b)
    errs += [info["c"][k] for k in ("add", "mean", "max")]
    info["c"]["empty_rows"] = int((~nbr_c.mask.any(-1)).sum())
    # (d) the list of (a) cut to the edges listed both ways by want_mirror
    g_d = build_dyn_graph(h_a, batch.mask, k=DRN_K, cap=DRN_CAP,
                          want_mirror=True)
    _, info["d"] = run_case("d", h_a, g_d.nbr, g0_a, gst_a)
    errs += [info["d"][k] for k in ("add", "mean", "max")]
    info["d"]["one_sided_slots_dropped"] = int(nbr_a.mask.sum()
                                               - g_d.nbr.mask.sum())

    # the reverse index's kernels against reverse_slots on every case's
    # lists, and on random lists (duplicate targets in a row, a target
    # many rows list) at N=8192
    Br, Nr, Kr = 2, 8192, 8
    idx_r = torch.as_tensor(rng.integers(0, Nr, size=(Br, Nr, Kr)),
                            dtype=torch.int32, device=device)
    idx_r[:, ::5, 0] = 7
    nbr_r = Neighborhood(idx_r, torch.as_tensor(
        rng.random((Br, Nr, Kr)) < 0.7, device=device))
    info["reverse_index_valid_slots"] = {
        c: check_reverse_index(c, n) for c, n in (
            ("a", nbr_a), ("b", nbr_b), ("c", nbr_c), ("d", g_d.nbr),
            ("random lists", nbr_r))}

    # two launches, bitwise equal (no atomics)
    with torch.no_grad():
        k0, _, _ = edge_mlp_fwd(a_a, h_a, nbr_a, w_diff, w1, b1, "add")
        args = (a_a, h_a, nbr_a, w_diff, w1, b1, "add", k0, None, g0_a, None,
                gst_a)
        r1, r2 = edge_mlp_bwd(*args), edge_mlp_bwd(*args)
    torch.cuda.synchronize()
    for name, u, v in zip(r1._fields, r1, r2):
        if not bitwise_equal(u, v):
            fail(f"edge_mlp_bwd: two launches differ in {name} "
                 f"({n_differ(u, v)} entries)")

    # the conv's gradients in train mode.  The BatchNorm variance of the
    # round-1 messages is as small as 1e-3 of their squared mean, so
    # var = Σh²/n − mean² loses about three digits to the order of the sums
    # (tests/test_torch_drn_train.py measures it), and a fixed f32 tolerance
    # between two summation orders does not hold.  The reference is the
    # plain path in f64: the kernels' gradients must lie within twice the
    # f32 plain path's own distance from it (per tensor), plus GRAD_ATOL.
    bn = model.convs[0].bn
    G = rng.normal(size=(B, N, H2))

    def plain_conv(x, nbr, m, gamma, beta):
        Hh = x.shape[-1]
        wd = m["lin0"]["w"][Hh:]
        a = torch.matmul(x, m["lin0"]["w"][:Hh] - wd) + m["lin0"]["b"]
        agg0, agg1, stats = edge_mlp_fwd_torch(a, x, nbr, wd, m["lin1"]["w"],
                                               m["lin1"]["b"], "add")
        return bn_combine(agg0, agg1, stats, nbr.mask, gamma, beta,
                          bn.running_mean.to(x.dtype),
                          bn.running_var.to(x.dtype), True, "add")

    def conv_grads(fn, dtype=torch.float32):
        leaves = [t.detach().to(dtype).clone().requires_grad_(True)
                  for t in (h_a, w0, b0, w1, b1, bn.gamma, bn.beta)]
        x, lw0, lb0, lw1, lb1, gm, bt = leaves
        m = {"lin0": {"w": lw0, "b": lb0}, "lin1": {"w": lw1, "b": lb1}}
        if fn is None:
            out, mean, var = plain_conv(x, nbr_a, m, gm, bt)
        else:
            out, mean, var = fn(x, nbr_a, m, gm, bt, bn.running_mean,
                                bn.running_var, True, "add")
        g = torch.as_tensor(G, dtype=dtype, device=device)
        ((out * g).sum() + mean.sum() + var.sum()).backward()
        return [t.grad.double() for t in leaves]

    conv_err, conv_info = 0.0, {}
    for name, k_, p_, t_ in zip(("x", "W0", "b0", "W1", "b1", "gamma", "beta"),
                                conv_grads(edge_mlp_conv), conv_grads(None),
                                conv_grads(None, torch.float64)):
        err_k = float((k_ - t_).abs().max())
        err_p = float((p_ - t_).abs().max())
        lim = 2.0 * err_p + GRAD_ATOL * float(t_.abs().max())
        conv_info[name] = {"kernel_vs_f64": err_k, "plain_f32_vs_f64": err_p}
        if not err_k <= lim:
            fail(f"gradient of {name} through edge_mlp_conv (train) is "
                 f"{err_k} from the f64 plain path's, past {lim} (twice the "
                 f"f32 plain path's {err_p}, plus GRAD_ATOL)")
        conv_err = max(conv_err, float((k_ - p_).abs().max()))

    # the per-node gradient kernels (dx, dW_diff from dzs) against their
    # plain products in f64, on (a)'s dzs
    with torch.no_grad():
        dzs = r1.dzs
        dx_n, dwd_n = edge_mlp_node_grads(h_a, dzs, w_diff)
    ref = node_grads_torch(h_a.double(), dzs.double(), w_diff.double())
    node_err = max(close_to_f64(f"edge_mlp_node_grads {name}", k_, r_)
                   for name, k_, r_ in zip(("dx", "dW_diff"), (dx_n, dwd_n),
                                           ref))

    # time and bound at (a)
    edges, nodes = int(nbr_a.mask.sum()), int(batch.mask.sum())
    ms = cuda_ms(lambda: edge_mlp_bwd(*args), 20)
    plain_ms = cuda_ms(lambda: edge_mlp_bwd_torch(*args), 3)
    # inputs a, x, idx, mask, the weights, agg0, g0, gst; outputs da, dx,
    # dzs and the weight gradients
    nbytes = (4 * (a_a.numel() + h_a.numel() + nbr_a.idx.numel()
                   + 2 * (w_diff.numel() + w1.numel() + b1.numel())
                   + 2 * B * N * H2 + 2 * H2 + 2 * a_a.numel()
                   + h_a.numel()) + nbr_a.mask.numel())
    # what these inputs need: x.W_diff, D.W_diff^T and X^T.D per real node;
    # z1, de0 and dW1 per valid edge
    ops = 6 * H * F1 * nodes + 6 * F1 * H2 * edges
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
    say("kernel_edge_mlp_bwd", name="edge_mlp_bwd",
        cases="a,b,c,d x add,mean,max within rtol 1e-5 + 2e-6 max|ref| of "
              "the plain version in f64; two launches bitwise equal; dx and "
              "dW_diff from dzs against their plain products in f64; the "
              "reverse index equal to reverse_slots",
        info=info,
        max_abs_err=max(errs), node_grads_max_abs_err=node_err,
        conv_grad_max_abs_err=conv_err, conv_grads=conv_info,
        shape=[B, N, K, H, F1, H2], real_nodes=nodes, valid_edges=edges,
        ms=ms, plain_ms=plain_ms, bytes=nbytes, fp32_ops=ops,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
        first_design_ms=EDGE_MLP_FIRST_DESIGN_MS[1])
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def drn_train_config(cfg):
    """``ckpts_syn_drn``'s training recipe on its run config: batch 16, the
    global-norm clip 10."""
    import dataclasses

    return dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, grad_clip_norm=10.0),
        data=dataclasses.replace(cfg.data, batch_size=DRN_TRAIN_B))


def drn_plain_f64_step(model, opt_state, tcfg, host, rounds):
    """The port's plain DRN train step in f64 on the CPU from ``model`` (a
    CPU copy taken before the step) and ``opt_state`` (the optimizer's
    state then, as ``optimizer_state_to_jax`` writes it), on the graphs ``rounds`` [(nbr, cluster, partner)]
    another run of the step built: they are injected in place of the graph
    build and the matching, whose decisions could differ at near-ties in
    f64.  Returns ``(loss, the model after the step)``; its ``.grad`` holds
    the clipped gradients."""
    from unittest import mock

    import torch
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.data.batching import Neighborhood
    from deepmetv2_tpu_torch.models import drn as tdrn
    from deepmetv2_tpu_torch.ops.dyn_graph import DynGraph
    from deepmetv2_tpu_torch.train.step import (make_drn_train_step,
                                                make_optimizer)

    ref = model.to(torch.float64)
    opt = make_optimizer(tcfg, ref)
    ref.optimizer_state_from_jax(opt_state, opt)
    batch = to_device(host, "cpu")
    batch = batch._replace(x_cont=batch.x_cont.double(), y=batch.y.double())
    graphs, matches = iter(rounds), iter(rounds)

    def graph(h, mask, **kw):
        nbr = next(graphs)[0]
        return DynGraph(nbr=Neighborhood(nbr.idx.cpu(), nbr.mask.cpu()),
                        d2v=None, t=None)

    def match(g, h, mask, *a, **kw):
        _, cluster, partner = next(matches)
        return cluster.cpu(), partner.cpu()

    with mock.patch.object(tdrn, "build_dyn_graph", graph), \
            mock.patch.object(tdrn, "cut_matching", match):
        loss = make_drn_train_step(tcfg)(ref, opt, batch)
    return float(loss), ref


def drn_step_against_f64(model, opt, tcfg, host, device):
    """One DRN train step of ``model`` on ``device``, held to
    ``drn_plain_f64_step`` on the graphs it built (the tolerances and their
    readings at DRN_STEP_LOSS_RTOL).  Returns ``(loss, rounds, info)`` with
    ``rounds`` each round's (mask, nbr, cluster, partner)."""
    import copy
    from unittest import mock

    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.models import drn as tdrn
    from deepmetv2_tpu_torch.train.step import make_drn_train_step

    before = copy.deepcopy(model).cpu(), model.optimizer_state_to_jax(opt)
    match = tdrn.cut_matching
    rounds = []

    def recorded(g, h, mask, *a, **kw):
        cluster, partner = match(g, h, mask, *a, **kw)
        rounds.append((mask, g.nbr, cluster, partner))
        return cluster, partner

    with mock.patch.object(tdrn, "cut_matching", recorded):
        loss = float(make_drn_train_step(tcfg)(model, opt,
                                               to_device(host, device)))
    ref_loss, ref = drn_plain_f64_step(*before, tcfg, host,
                                       [r[1:] for r in rounds])
    info = {"loss": loss, "f64_loss": ref_loss,
            "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss)}
    if not info["loss_rel_err"] <= DRN_STEP_LOSS_RTOL:
        fail(f"DRN train step: loss {loss} is {info['loss_rel_err']} from the "
             f"plain step's in f64 ({ref_loss}), past {DRN_STEP_LOSS_RTOL}")
    worst = {"grad": 0.0, "param": 0.0, "bn": 0.0}
    for (path, got), (_, want) in zip(model.jax_layout(), ref.jax_layout()):
        checks = [("bn", got, want, DRN_STEP_BN_ATOL, True)]
        if path[0] == "params":
            checks = [("param", got, want, DRN_STEP_PARAM_ATOL, False),
                      ("grad", got.grad, want.grad, DRN_STEP_GRAD_ATOL, True)]
        for kind, g, w, tol, scaled in checks:
            g, w = g.detach().cpu().double(), w.detach().double()
            scale = float(w.abs().max()) if scaled else 1.0
            err = float((g - w).abs().max()) / (scale or 1.0)
            worst[kind] = max(worst[kind], err)
            if not err <= tol:
                fail(f"DRN train step: {kind} of {path} is {err} from the "
                     f"plain step's in f64 (scaled by its max: {scaled}), "
                     f"past {tol}")
    info.update({f"max_{k}_err": v for k, v in worst.items()})
    return loss, rounds, info


def drn_train_resume_phase(device, cfg):
    """10 DRN train steps from ckpts_syn_drn/best.ckpt (weights, BatchNorm,
    the optax chain's AdamW state, scheduler) on the first 10 train batches
    of synthetic 2000 at batch 16, each loss held to GOLDEN_DRN_TRAIN_LOSSES
    by the rule stated there, and step 0 to the port's plain step in f64
    (drn_step_against_f64).  Returns the trained model and its
    optimizer."""
    import itertools
    from unittest import mock

    import numpy as np
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models import drn as tdrn
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
    from deepmetv2_tpu_torch.train.step import (make_drn_train_step,
                                                make_optimizer)

    tcfg = drn_train_config(cfg)
    model = tdrn.DRN(tcfg.drn, device=device)
    opt = make_optimizer(tcfg, model)
    sched = ReduceLROnPlateau(lr=tcfg.optim.lr)
    payload = restore_checkpoint(os.path.join(HERE, DRN_CKPTS, "best.ckpt"),
                                 model, opt, sched)
    ld = fetch_dataloader(events=synthetic_events(2000, seed=42),
                          batch_size=DRN_TRAIN_B)["train"]
    step = make_drn_train_step(tcfg)
    match = tdrn.cut_matching
    losses, graphs = [], []
    hosts = itertools.islice(iter(ld), len(GOLDEN_DRN_TRAIN_LOSSES))
    loss0, rounds, step0 = drn_step_against_f64(model, opt, tcfg, next(hosts),
                                                device)
    losses.append(loss0)
    graphs.append(drn_graph_digests([[t.cpu().numpy() for t in (
        m, nbr.idx, nbr.mask, c, p)] for m, nbr, c, p in rounds]))
    del rounds
    for host in hosts:
        rounds = []

        def recorded(g, h, mask, *a, **kw):
            cluster, partner = match(g, h, mask, *a, **kw)
            rounds.append([t.cpu().numpy() for t in
                           (mask, g.nbr.idx, g.nbr.mask, cluster, partner)])
            return cluster, partner

        with mock.patch.object(tdrn, "cut_matching", recorded):
            losses.append(float(step(model, opt, to_device(host, device))))
        graphs.append(drn_graph_digests(rounds))
    gold = np.load(os.path.join(HERE, GOLDEN_DRN_TRAIN_GRAPHS))
    same = [bool(np.array_equal(g, w)) for g, w in zip(graphs, gold)]
    held = int(np.argmin(same + [False]))     # steps before the first change
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, GOLDEN_DRN_TRAIN_LOSSES)]
    say("drn_train_resume", epoch=payload["epoch"], adam_count=payload["step"],
        losses=losses, golden=GOLDEN_DRN_TRAIN_LOSSES, rel_err=rel,
        steps_with_jax_graphs=[i for i, v in enumerate(same) if v],
        events_with_other_graphs=[int((g != w).any(-1).sum())
                                  for g, w in zip(graphs, gold)],
        steps_held_at_loss_rtol=held, step0_against_plain_f64=step0)
    for i, r in enumerate(rel):
        lim = LOSS_RTOL if i < held else DRN_TRAIN_LATE_RTOL
        if not r <= lim:
            fail(f"DRN resumed train step {i}: loss {losses[i]} is {r} from "
                 f"the JAX package's {GOLDEN_DRN_TRAIN_LOSSES[i]}, not within "
                 f"{lim}")
    return model, opt, tcfg


def drn_train_counters():
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import edge_mlp_bwd

    return dict(drn_counters(), edge_mlp_bwd=edge_mlp_bwd)


def drn_train_phase(work: str):
    """The train CLI with --model drn: 2 epochs into build/smoke/drn_train
    and a resume to 3; exact launch counts; artifacts; finite losses, epoch
    2's train loss below epoch 1's; best.ckpt re-evaluated by the evaluate
    CLI.  Returns the launches per kernel over both runs."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import train as train_cli

    ck = os.path.join(work, "drn_train")
    base = ["--model", "drn", "--drn_head", "cartesian", "--synthetic", "2000",
            "--batch_size", str(DRN_TRAIN_B), "--grad_clip", "10",
            "--plateau_patience", "10", "--bn_refresh", str(DRN_REFRESH),
            "--ckpts", ck]
    steps, evals, rounds = 100, 25, 2        # per epoch: 1600 / 16, 400 / 16
    counters = drn_train_counters()
    total = {k: 0 for k in counters}
    for argv, epochs in ((["--epochs", "2"], 2),
                         (["--epochs", "3", "--restore_file", "last"], 1)):
        for fn in counters.values():
            fn.launches = 0
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_cli.main(base + argv)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in counters.items()}
        text = out.getvalue()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("drn:", "feed:", "Training epoch",
                                   "- Eval", "Restarting"))]
        say("drn_train", argv=argv, seconds=sec, launches=launches,
            epoch_seconds=epoch_seconds(text), log=lines)
        if rc != 0:
            fail(f"DRN train CLI {argv} exited {rc}")
        check_feed_line("DRN train CLI", text)
        fwd = epochs * (steps + DRN_REFRESH + evals) * rounds
        want = {k: fwd for k in drn_counters()}
        want["edge_mlp_bwd"] = epochs * steps * rounds
        if launches != want:
            fail(f"DRN train CLI {argv}: launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] += v
    for f in ("loss.log", "metrics_val_best.json", "metrics_val_last.json",
              "best.resolutions", "last.resolutions", "best.ckpt", "last.ckpt",
              "config.json"):
        if not os.path.exists(os.path.join(ck, f)):
            fail(f"DRN train CLI wrote no {f}")
    rows = [ln.split(",") for ln in open(os.path.join(ck, "loss.log"))
            if ln[:1].isdigit()]
    if [r[0] for r in rows] != ["1", "2", "3"] or not all(
            np.isfinite(float(v)) for r in rows for v in r[1:]):
        fail(f"DRN loss.log rows are not epochs 1-3 with finite losses: {rows}")
    if not float(rows[1][1]) < float(rows[0][1]):
        fail(f"DRN train loss did not fall from epoch 1 to 2: {rows}")
    with open(os.path.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    ev = os.path.join(work, "drn_train_eval")
    os.makedirs(ev)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(ck, f), ev)
    got = evaluate_cli.run(["--model", "drn", "--synthetic", "2000", "--ckpts",
                            ev, "--batch_size", str(DRN_TRAIN_B)])["loss"]
    rel = abs(got - best) / abs(best)
    say("drn_train_reeval", metrics_val_best=best, evaluate_cli=got,
        rel_err=rel, loss_log=[",".join(r).strip() for r in rows])
    if not rel <= REEVAL_RTOL:
        fail(f"evaluate CLI gives {got} on the DRN train CLI's best.ckpt, not "
             f"within {REEVAL_RTOL} of its metrics_val_best.json {best}")
    return total


def probe_phase(device):
    """The pipelined window forward (the revolver probe's port) through the
    probe module, which holds it bitwise to window_max_fwd and the plain
    version at both probe shapes and times both kernels; then its error,
    the plain version's time and the bound at the first shape.  Returns
    (the probe's launches, the kernel-line entries)."""
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import \
        window_max_pipelined
    from deepmetv2_tpu_torch.ops.window import padded_rows, window_max_torch
    from deepmetv2_tpu_torch.probes import window_revolver

    window_max_pipelined.launches = 0
    rows = window_revolver.run(device)
    launches = window_max_pipelined.launches
    B, N, H = window_revolver.SHAPES[0]
    c, pos, halo = window_revolver.probe_inputs(B, N, H, seed=N + H,
                                                device=device)
    r2 = window_revolver.R ** 2
    real = ~padded_rows(pos)
    got = window_max_pipelined(c, pos, r2, halo)
    plain = window_max_torch(c, pos, real, r2, halo)
    fin = torch.isfinite(plain)
    if not (torch.equal(torch.isfinite(got), fin) and bitwise_equal(got, plain)):
        fail("window_max_fwd_pipelined differs from the plain version")
    err = float((got[fin] - plain[fin]).abs().max())
    plain_ms = cuda_ms(lambda: window_max_torch(c, pos, real, r2, halo), 3)
    pairs, adj = window_work(pos, real, halo, r2)
    bound_ms, bound_by, _, _ = bound(window_bytes(pos, H, 1),
                                     6 * pairs + H * adj)
    first = rows[f"{B}x{N}x{H}"]
    say("probe", name="window_max_fwd_pipelined", shapes=rows,
        launches=launches, max_abs_err=err, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, at=[B, N, H])
    return launches, {"max_abs_err": err, "ms": first["pipelined_ms"],
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}


def drn_train_profile(device, model, opt, tcfg) -> None:
    """One DRN train step (16 events, N=2048): step time from CUDA events,
    device time by kernel from torch.profiler."""
    import itertools

    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.train.step import make_drn_train_step

    ld = fetch_dataloader(events=synthetic_events(2000, seed=42),
                          batch_size=DRN_TRAIN_B)["train"]
    batch = to_device(next(itertools.islice(iter(ld), 1)), device)
    step = make_drn_train_step(tcfg)
    step_ms = cuda_ms(lambda: step(model, opt, batch), 10)
    dev_ms, n_k, top = step_profile(lambda: step(model, opt, batch), reps=3)
    say("profile", step="drn_train", batch=[batch.batch_size, batch.max_nodes],
        step_ms=step_ms, device_ms=dev_ms, device_busy_share=dev_ms / step_ms,
        device_idle_share=1 - dev_ms / step_ms, kernels_per_step=n_k, top=top)


REPLAY_STEPS, REPLAY_CHAIN, REPLAY_LR = 24, 8, 5e-4


def family_setup(device, family: str):
    """``(fresh, cfg, loader)`` for a train run of ``family`` from its
    committed checkpoint: ``fresh()`` gives a new ``(model, optimizer)``
    restored from it (weights, BatchNorm, AdamW state), ``cfg`` the train
    config, ``loader`` the train loader of synthetic 2000.  GraphMET:
    ckpts_syn at batch 8, halo 192, cell order (presorted); the DRN:
    ckpts_syn_drn at batch 16 with its clip (drn_train_config)."""
    import dataclasses

    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
    from deepmetv2_tpu_torch.models.drn import DRN
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.step import make_optimizer

    events = synthetic_events(2000, seed=42)
    if family == "drn":
        ck = os.path.join(HERE, DRN_CKPTS)
        cfg = drn_train_config(load_run_config(ck))
        loader = fetch_dataloader(events=events,
                                  batch_size=DRN_TRAIN_B)["train"]
    else:
        ck = os.path.join(HERE, "ckpts_syn")
        cfg = load_run_config(ck)
        cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
            cfg.graph, mode="window", window_halo=TRAIN_HALO, presorted=True))
        loader = fetch_dataloader(events=events, batch_size=TRAIN_B,
                                  presort_eta=True,
                                  presort_mode="cell")["train"]

    def fresh():
        model = (DRN(cfg.drn, device=device) if family == "drn"
                 else GraphMET(cfg.model, device=device))
        opt = make_optimizer(cfg, model)
        restore_checkpoint(os.path.join(ck, "best.ckpt"), model, opt)
        return model, opt

    return fresh, cfg, loader


def train_state(model, opt):
    """[(kind, copy of the tensor)]: every parameter ('param') and
    BatchNorm buffer ('bn'), then each parameter's AdamW moments and step
    count ('adam')."""
    out = [("bn" if path[0] == "bn_state" else "param", t.detach().clone())
           for path, t in model.jax_layout()]
    for _, t in model._param_paths():
        out += [("adam", opt.state[t][k].clone())
                for k in ("exp_avg", "exp_avg_sq", "step")]
    return out


def max_differ(a, b) -> float:
    """Largest |a − b|, 0.0 where bitwise equal (a zero's sign forgiven)."""
    import torch

    if a.dtype.is_floating_point:
        if bitwise_equal(a, b):
            return 0.0
    elif torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


def run_differ(a_losses, a_state, b_losses, b_state):
    """{kind: largest |difference|} between two runs' losses and states."""
    out = {"loss": max_differ(a_losses, b_losses), "param": 0.0, "bn": 0.0,
           "adam": 0.0}
    for (kind, x), (_, y) in zip(a_state, b_state):
        out[kind] = max(out[kind], max_differ(x, y))
    return out


def chain_replay_phase(device, family: str) -> None:
    """Replayed chains against eager steps, from the committed checkpoint:
    REPLAY_STEPS train steps eagerly on one copy, twice (two eager runs
    from the same state: what the card does run to run), and on another
    copy through the chained runner in chains of REPLAY_CHAIN (the first
    chain eager on its side stream, the second captured and replayed, the
    third replayed on another stack), the lr set to REPLAY_LR before the
    third chain in every run.  Every loss, parameter, BatchNorm buffer and
    AdamW moment and step must equal the eager run's bitwise, or, where
    the two eager runs differ, within the largest difference they show in
    that kind; the kernels' launches (replays included) must equal the
    eager run's."""
    import torch
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.ops.cuda import build
    from deepmetv2_tpu_torch.train.chain import (make_chained_train_step,
                                                 stack_batches)
    from deepmetv2_tpu_torch.train.step import (drn_objective,
                                                graphmet_objective,
                                                make_train_step,
                                                set_learning_rate)

    fresh, cfg, loader = family_setup(device, family)
    hosts = []
    for b in loader:
        hosts.append(b)
        if len(hosts) == REPLAY_STEPS:
            break
    batches = [to_device(b, device) for b in hosts]
    stacks = [to_device(stack_batches(hosts[i:i + REPLAY_CHAIN]), device)
              for i in range(0, REPLAY_STEPS, REPLAY_CHAIN)]
    objective = (drn_objective(cfg) if family == "drn"
                 else graphmet_objective(cfg))
    lr_at = 2 * REPLAY_CHAIN

    def eager():
        model, opt = fresh()
        step = make_train_step(cfg, objective)
        before = build.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for i, b in enumerate(batches):
            if i == lr_at:
                set_learning_rate(opt, REPLAY_LR)
            losses.append(step(model, opt, b))
        torch.cuda.synchronize()
        after = build.launch_counts()
        return (torch.stack(losses), train_state(model, opt),
                {k: after[k] - before[k] for k in after if after[k] - before[k]},
                torch.cuda.max_memory_allocated())

    a_losses, a_state, a_launch, a_peak = eager()
    b_losses, b_state, _, _ = eager()
    run_to_run = run_differ(a_losses, a_state, b_losses, b_state)

    model, opt = fresh()
    runner = make_chained_train_step(cfg, family)
    before = build.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for c, st in enumerate(stacks):
        if c * REPLAY_CHAIN == lr_at:
            set_learning_rate(opt, REPLAY_LR)
        losses.append(runner(model, opt, st))
    torch.cuda.synchronize()
    after = build.launch_counts()
    c_peak = torch.cuda.max_memory_allocated()
    c_launch = {k: after[k] - before[k] for k in after if after[k] - before[k]}
    c_losses = torch.cat(losses)
    replay = run_differ(a_losses, a_state, c_losses, train_state(model, opt))
    say("chain_replay", family=family, steps=REPLAY_STEPS, chain=REPLAY_CHAIN,
        graphs=runner.n_graphs, replays=runner.replays, lr_before_chain_3=
        REPLAY_LR, eager_run_to_run=run_to_run, replay_against_eager=replay,
        bitwise=not any(replay.values()), launches=c_launch,
        eager_launches=a_launch, peak_mb_eager=a_peak / 2 ** 20,
        peak_mb_graphs=c_peak / 2 ** 20, losses=c_losses.tolist())
    if (runner.n_graphs, runner.replays) != (1, 2):
        fail(f"chain_replay {family}: {runner.n_graphs} graphs and "
             f"{runner.replays} replays, want 1 and 2")
    for kind, d in replay.items():
        if not d <= run_to_run[kind]:
            fail(f"chain_replay {family}: the replayed chains' {kind} differ "
                 f"from the eager steps' by {d}; two eager runs differ by "
                 f"{run_to_run[kind]}")
    if c_launch != a_launch:
        fail(f"chain_replay {family}: launches {c_launch} with replays, "
             f"eager {a_launch}")


def feed_profile(device, family: str) -> None:
    """One training epoch of synthetic 2000 from the committed checkpoint
    under each feed: per-step dispatch with a copy of each batch
    (chain_steps 1, resident_feed false) and the chained resident replay
    (chain_steps REPLAY_CHAIN, the epoch staged once).  Each feed runs
    two epochs first: the epoch's chains have several (shape, length)
    keys, and a key seen once per epoch is warmed up in the first and
    captured in the second.  Then one epoch timed by the host clock (ms
    per step) and one under torch.profiler (the device's kernel and copy
    time per step); the idle share is 1 − device / wall."""
    import torch
    from deepmetv2_tpu_torch.train.chain import make_chained_train_step
    from deepmetv2_tpu_torch.train.loop import train_one_epoch
    from deepmetv2_tpu_torch.train.resident import ResidentFeed
    from deepmetv2_tpu_torch.train.step import (drn_objective,
                                                graphmet_objective,
                                                make_train_step)

    fresh, cfg, loader = family_setup(device, family)
    objective = (drn_objective(cfg) if family == "drn"
                 else graphmet_objective(cfg))
    steps = len(loader)
    for mode in ("per_step_streaming", "chained_resident"):
        model, opt = fresh()
        if mode == "chained_resident":
            step = make_chained_train_step(cfg, family)
            feed, chain = ResidentFeed(loader, REPLAY_CHAIN, device), REPLAY_CHAIN
        else:
            step, feed, chain = make_train_step(cfg, objective), loader, 1

        def epoch():
            return train_one_epoch(model, opt, step, feed, 0, device,
                                   verbose=False, chain=chain)

        warm_s = []
        for _ in range(2):
            t = time.perf_counter()
            epoch()
            warm_s.append(time.perf_counter() - t)
        graphs = getattr(step, "n_graphs", 0)
        replays = getattr(step, "replays", 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        epoch()                       # ends in a host read of its loss
        wall_ms = 1e3 * (time.perf_counter() - t)
        replays = getattr(step, "replays", 0) - replays
        dev_ms, n_k, top = step_profile(epoch, reps=1, cpu=False)
        if getattr(step, "n_graphs", 0) != graphs:
            fail(f"feed {family}: graphs were captured after two epochs")
        say("feed", family=family, mode=mode, chain=chain, steps=steps,
            card=CARD, warm_epochs_s=warm_s, graphs=graphs,
            replays_in_epoch=replays, epoch_s=wall_ms / 1e3,
            ms_per_step=wall_ms / steps, device_ms_per_step=dev_ms / steps,
            idle_share=1 - dev_ms / wall_ms, kernels_per_step=n_k / steps,
            top=top[:4])
        if not dev_ms > 0:
            fail(f"feed {family} {mode}: the profile saw no device work")


def check_predictions(z, what: str) -> None:
    """The GraphMET predict CLI's npz ``z`` over synthetic 2000: every
    event in input order, finite MET, weights in [0, 1] and 0 at
    padding."""
    import numpy as np

    w, nv = z["weights"], z["n_valid"]
    real = np.arange(w.shape[1])[None, :] < nv[:, None]
    if len(z["met"]) != 2000 or not np.array_equal(z["event_index"],
                                                   np.arange(2000)):
        fail(f"{what} did not return 2000 events in input order")
    if not np.all(np.isfinite(z["met"])):
        fail(f"{what} returned non-finite MET")
    if not (np.all((w[real] >= 0) & (w[real] <= 1)) and np.all(w[~real] == 0)):
        fail(f"{what} weights outside [0, 1] or nonzero at padding")


def ckpt_copy(work: str, name: str, src: str = "ckpts_syn") -> str:
    """A fresh copy of a committed run's config.json and best.ckpt."""
    ck = os.path.join(work, name)
    os.makedirs(ck)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(HERE, src, f), ck)
    return ck


def peak_run(fn):
    """``(fn(), seconds, peak device MiB)``, synchronized."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t,
            torch.cuda.max_memory_allocated() / 2 ** 20)


def nl_evaluate_phase(work: str) -> float:
    """The evaluate CLI in neighbor_list mode on synthetic 2000 from a copy
    of ckpts_syn: the loss within LOSS_RTOL of GOLDEN_NL_LOSS, no window
    kernel launched; returns the loss."""
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import window_max

    ck = ckpt_copy(work, "nl")
    window_max.launches = 0
    metrics, sec, peak = peak_run(lambda: evaluate_cli.run(
        ["--synthetic", "2000", "--ckpts", ck, "--restore_file", "best",
         "--graph_mode", "neighbor_list"]))
    loss = metrics["loss"]
    rel = abs(loss - GOLDEN_NL_LOSS) / GOLDEN_NL_LOSS
    say("nl_evaluate", loss=loss, golden=GOLDEN_NL_LOSS, rel_err=rel,
        window_max_launches=window_max.launches, seconds=sec, peak_mb=peak)
    if not rel <= LOSS_RTOL:
        fail(f"neighbor_list validation loss {loss} is not within "
             f"{LOSS_RTOL} of {GOLDEN_NL_LOSS}")
    if window_max.launches:
        fail(f"neighbor_list evaluate launched window_max "
             f"{window_max.launches} times")
    return loss


def nl_predict_phase(work: str) -> None:
    """The predict CLI in neighbor_list mode over synthetic 2000."""
    import numpy as np
    from deepmetv2_tpu_torch.cli import predict as predict_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import window_max

    out = os.path.join(work, "pred_nl.npz")
    window_max.launches = 0
    _, sec, peak = peak_run(lambda: predict_cli.main(
        ["--synthetic", "2000", "--ckpts", os.path.join(work, "nl"),
         "--out", out, "--graph_mode", "neighbor_list"]))
    z = np.load(out)
    say("nl_predict", events=int(len(z["met"])), seconds=sec, peak_mb=peak,
        window_max_launches=window_max.launches,
        met_mean=float(np.mean(z["met"])))
    check_predictions(z, "neighbor_list predict")
    if window_max.launches:
        fail(f"neighbor_list predict launched window_max "
             f"{window_max.launches} times")


def from_torch_phase(work: str, window_loss: float, nl_loss: float) -> None:
    """ckpts_syn/best.ckpt's weights written as a reference .pth.tar
    (write_reference_checkpoint), then ``evaluate --from_torch`` into fresh
    directories: in window mode bitwise the native checkpoint's loss of
    phase 5, in neighbor_list mode bitwise nl_evaluate's."""
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint

    payload = load_checkpoint(os.path.join(HERE, "ckpts_syn", "best.ckpt"))
    pth = os.path.join(work, "reference", "best.pth.tar")
    os.makedirs(os.path.dirname(pth))
    write_reference_checkpoint(payload["params"], payload["bn_state"], pth,
                               epoch=payload["epoch"])
    got = {}
    for mode, want in (("window", window_loss), ("neighbor_list", nl_loss)):
        (m, sec, _) = peak_run(lambda: evaluate_cli.run(
            ["--synthetic", "2000", "--from_torch", pth, "--graph_mode",
             mode, "--ckpts", os.path.join(work, f"from_torch_{mode}")]))
        got[mode] = (m["loss"], want, sec)
    say("from_torch", **{m: {"loss": a, "native_loss": b, "bitwise": a == b,
                             "seconds": t} for m, (a, b, t) in got.items()})
    for mode, (a, b, _) in got.items():
        if a != b:
            fail(f"evaluate --from_torch ({mode}) gives {a}, the native "
                 f"checkpoint {b}")


def nl_train_resume_phase(device) -> None:
    """10 train steps from ckpts_syn/best.ckpt in neighbor_list mode (the
    batches unsorted, as the train CLI leaves them in this mode) through
    the chained runner as chains of 8 and 2, each loss within LOSS_RTOL of
    GOLDEN_NL_TRAIN_LOSSES."""
    import itertools

    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.chain import (make_chained_train_step,
                                                 stack_batches)
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.step import make_optimizer

    ck = os.path.join(HERE, "ckpts_syn")
    cfg = load_run_config(ck)               # its graph: neighbor_list, 256
    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(cfg, model)
    restore_checkpoint(os.path.join(ck, "best.ckpt"), model, opt)
    ld = fetch_dataloader(events=synthetic_events(2000, seed=42),
                          batch_size=TRAIN_B)["train"]
    hosts = list(itertools.islice(iter(ld), len(GOLDEN_NL_TRAIN_LOSSES)))
    runner = make_chained_train_step(cfg)

    def run():
        return [v for chain in (hosts[:8], hosts[8:]) for v in runner(
            model, opt, to_device(stack_batches(chain), device)).tolist()]

    losses, sec, peak = peak_run(run)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, GOLDEN_NL_TRAIN_LOSSES)]
    say("nl_train_resume", graph=cfg.graph.mode, k=cfg.graph.max_neighbors,
        chains=[8, 2], losses=losses, golden=GOLDEN_NL_TRAIN_LOSSES,
        max_rel_err=max(rel), seconds=sec, peak_mb=peak)
    if cfg.graph.mode != "neighbor_list" or not max(rel) <= LOSS_RTOL:
        fail(f"neighbor_list train losses are not within {LOSS_RTOL} of the "
             f"JAX package's: {losses}")


def nl_train_phase(work: str) -> None:
    """The train CLI with --graph_mode neighbor_list for 1 epoch on
    synthetic 2000, chained and resident by the config (its "feed:" line);
    its best.ckpt re-evaluated by the evaluate CLI within REEVAL_RTOL."""
    import torch
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import train as train_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)

    ck = os.path.join(work, "nl_train")
    window_max.launches = window_max_bwd.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, sec, peak = peak_run(lambda: train_cli.main(
            ["--synthetic", "2000", "--batch_size", str(TRAIN_B), "--ckpts",
             ck, "--epochs", "1", "--graph_mode", "neighbor_list"]))
    text = out.getvalue()
    with open(os.path.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    with open(os.path.join(ck, "config.json")) as f:
        graph = json.load(f)["graph"]
    ev = ckpt_copy(work, "nl_train_eval", ck)
    got = evaluate_cli.run(["--synthetic", "2000", "--ckpts", ev,
                            "--batch_size", str(TRAIN_B), "--graph_mode",
                            "neighbor_list"])["loss"]
    torch.cuda.synchronize()
    rel = abs(got - best) / abs(best)
    say("nl_train", seconds=sec, peak_mb=peak,
        epoch_seconds=epoch_seconds(text), graph=graph,
        window_launches=[window_max.launches, window_max_bwd.launches],
        metrics_val_best=best, evaluate_cli=got, rel_err=rel,
        log=[ln for ln in text.splitlines()
             if ln.startswith(("feed:", "Training epoch", "- Eval"))])
    if rc != 0:
        fail(f"neighbor_list train CLI exited {rc}")
    check_feed_line("neighbor_list train CLI", text)
    if "graph mode: window" in text or graph["mode"] != "neighbor_list" \
            or graph["presorted"]:
        fail(f"neighbor_list train CLI ran in another graph mode: {graph}")
    if window_max.launches or window_max_bwd.launches:
        fail("neighbor_list train CLI launched the window kernels")
    if not rel <= REEVAL_RTOL:
        fail(f"evaluate CLI gives {got} on the neighbor_list train CLI's "
             f"best.ckpt, not within {REEVAL_RTOL} of {best}")


def drn_golden_rule(name: str, ld, losses, met, graphs, gold_met: str,
                    gold_graphs: str, **extra) -> dict:
    """Hold a DRN validation pass (``drn_eval_pass``) to a JAX golden's
    per-event MET and graph digests: an event may miss DRN_EVENT_RTOL only
    where its graph decisions differ from the JAX package's (near-ties,
    ROADMAP C), at most DRN_MAX_GRAPH_EVENTS such, and the loss over the
    other events must equal the JAX loss over the same events within
    DRN_KEPT_RTOL.  Prints the phase line; returns its numbers."""
    import numpy as np

    gold = np.load(os.path.join(HERE, gold_met))
    gold_g = np.load(os.path.join(HERE, gold_graphs))
    gen = np.stack([np.asarray(ld.dataset[int(i)][1][:2])
                    for i in np.concatenate(ld._batches)])
    if met.shape != gold.shape or graphs.shape != gold_g.shape:
        fail(f"{name}: {met.shape} / {graphs.shape} events checked, the JAX "
             f"package's files hold {gold.shape} / {gold_g.shape}")
    differs = graphs != gold_g                             # [events, rounds]
    diverged = differs.any(axis=1)
    dev = np.abs(met - gold).max(axis=1)
    scale = np.maximum(np.abs(gold).max(axis=1), 1.0)
    off = dev > DRN_EVENT_RTOL * scale
    per_t = 0.5 * ((met - gen) ** 2).sum(1)
    per_j = 0.5 * ((gold - gen) ** 2).sum(1)
    kept_rel = (abs(per_t[~diverged].mean() - per_j[~diverged].mean())
                / per_j[~diverged].mean())
    out = dict(extra, pass_loss=float(np.mean(np.asarray(losses,
                                                          np.float64))),
               events=int(len(met)), graph_events=int(diverged.sum()),
               graph_events_by_round=[int(c) for c in differs.sum(axis=0)],
               events_off=int(off.sum()),
               off_events=[int(i) for i in np.flatnonzero(off)],
               off_max_abs_met=float(dev[off].max()) if off.any() else 0.0,
               kept_events=int((~diverged).sum()),
               kept_max_rel_met=float((dev / scale)[~diverged].max()),
               kept_loss_rel_err=float(kept_rel))
    say(name, **out)
    if (off & ~diverged).any():
        fail(f"{name}: events {np.flatnonzero(off & ~diverged).tolist()} "
             f"differ from the JAX package's MET by more than "
             f"{DRN_EVENT_RTOL} although their graphs equal its graphs")
    if diverged.sum() > DRN_MAX_GRAPH_EVENTS:
        fail(f"{name}: {int(diverged.sum())} of {len(met)} events have graph "
             f"decisions unlike the JAX package's; at most "
             f"{DRN_MAX_GRAPH_EVENTS} may (near-ties)")
    if not kept_rel <= DRN_KEPT_RTOL:
        fail(f"{name}: the loss over the events with the JAX graphs is "
             f"{kept_rel} from the JAX package's, not within {DRN_KEPT_RTOL}")
    return out


def drn_composed_phase(device) -> None:
    """The DRN on the 400 validation events of synthetic 2000 at batch 8
    with the composed graph build and the gather-reduce conv
    (``graph_force='composed', conv_force='xla'``), held to the JAX
    package's CPU default, its composed path (GOLDEN_DRN_COMPOSED_*), by
    drn_golden_rule, no DRN kernel launched; then one train-mode forward
    and backward on a train batch with ``mirror_gather`` off and on, on the
    same graphs: every gradient within DRN_MIRROR_ATOL of the largest."""
    import dataclasses

    import torch
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.drn import DRN, drn_net_apply
    from deepmetv2_tpu_torch.train.loss import drn_loss_fn

    model, cfg = drn_model(device)
    forces = dict(graph_force="composed", conv_force="xla")
    counters = drn_counters()
    for fn in counters.values():
        fn.launches = 0
    ld = drn_val_loader(cfg, 8)
    (losses, met, graphs), sec, peak = peak_run(
        lambda: drn_eval_pass(model, ld, device, **forces))
    launches = {k: fn.launches for k, fn in counters.items()}
    drn_golden_rule("drn_composed", ld, losses, met, graphs,
                    GOLDEN_DRN_COMPOSED_MET, GOLDEN_DRN_COMPOSED_GRAPHS,
                    golden_loss=GOLDEN_DRN_COMPOSED_LOSS, seconds=sec,
                    peak_mb=peak, launches=launches)
    if any(launches.values()):
        fail(f"the composed DRN launched {launches}")

    host = next(iter(fetch_dataloader(events=synthetic_events(2000, seed=42),
                                      batch_size=DRN_TRAIN_B)["train"]))
    batch = to_device(host, device)
    grads = []
    for mirror in (False, True):
        m = DRN(dataclasses.replace(cfg.drn, mirror_gather=mirror),
                device=device)
        m.load_state_dict(model.state_dict())
        m.train()
        loss = drn_loss_fn(drn_net_apply(m, batch, **forces), batch,
                           cfg.drn.head)
        loss.backward()
        grads.append((float(loss.detach()), [p.grad for p in m.parameters()]))
    top = max(float(g.abs().max()) for g in grads[0][1])
    diff = max(float((a - b).abs().max())
               for a, b in zip(grads[0][1], grads[1][1]))
    say("drn_composed_mirror", batch=[batch.batch_size, batch.max_nodes],
        losses=[grads[0][0], grads[1][0]], max_abs_grad=top,
        max_grad_diff=diff, rel=diff / top)
    if grads[0][0] != grads[1][0] or not diff <= DRN_MIRROR_ATOL * top:
        fail(f"mirror_gather on and off: losses {grads[0][0]}, "
             f"{grads[1][0]}, gradients {diff} apart (largest {top})")


def nl_profile(device) -> None:
    """One neighbor_list evaluation step (40 events, N=2048, K=256) and one
    train step (8 events): wall ms from CUDA events, device ms by kernel
    from torch.profiler, peak memory; and, on the same inputs, the radius
    graph build, the gather of c ``[B, N, K, H]`` and its backward (the
    scatter-add adjoint) alone."""
    import itertools

    import torch
    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.ops.segment import gather_neighbors
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.step import (build_graph, make_eval_step,
                                                make_optimizer,
                                                make_train_step)

    ck = os.path.join(HERE, "ckpts_syn")
    cfg = load_run_config(ck)
    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(cfg, model)
    restore_checkpoint(os.path.join(ck, "best.ckpt"), model, opt)
    events = synthetic_events(2000, seed=42)
    eval_b = to_device(next(iter(fetch_dataloader(events=events,
                                                  batch_size=40)["test"])),
                       device)
    train_b = to_device(next(itertools.islice(iter(fetch_dataloader(
        events=events, batch_size=TRAIN_B)["train"]), 1)), device)
    eval_step, train_step = make_eval_step(cfg), make_train_step(cfg)
    H = cfg.model.hidden_dim
    for name, batch, step in (
            ("nl_eval", eval_b, lambda: eval_step(model, eval_b)),
            ("nl_train", train_b, lambda: train_step(model, opt, train_b))):
        _, _, peak = peak_run(step)
        step_ms = cuda_ms(step, 10)
        dev_ms, n_k, top = step_profile(step, reps=3)
        _, nbr = build_graph(batch, cfg)
        c = torch.randn(batch.batch_size, batch.max_nodes, H, device=device,
                        requires_grad=True)
        g = gather_neighbors(c, nbr)
        ct = torch.randn_like(g)
        parts = {
            "radius_graph_ms": cuda_ms(lambda: build_graph(batch, cfg), 5),
            "gather_ms": cuda_ms(lambda: gather_neighbors(c.detach(), nbr),
                                 5),
            "gather_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                g, c, ct, retain_graph=True), 5)}
        say("profile", step=name, card=CARD,
            batch=[batch.batch_size, batch.max_nodes],
            k=cfg.graph.max_neighbors, step_ms=step_ms, device_ms=dev_ms,
            device_idle_share=1 - dev_ms / step_ms, peak_mb=peak,
            kernels_per_step=n_k, top=top, **parts)
        del g, ct, c, nbr


def main() -> int:
    t_run = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "deepmetv2_tpu_torch")):
        fail("deepmetv2_tpu_torch/ is not next to chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, HERE)
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # the reference is f32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    global CARD
    CARD = smi[0] if smi else "nvidia-smi: no output"
    print(CARD, flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    from deepmetv2_tpu_torch.ops.cuda import build
    t = time.perf_counter()
    reports = build.build()
    sec = time.perf_counter() - t
    regs = {k: [ln.split(":", 1)[1].strip() for ln in v["log"].splitlines()
                if "registers" in ln] for k, v in reports.items()}
    say("build", kernels=list(build.KERNELS), seconds=sec,
        seconds_by_source={k: v["seconds"] for k, v in reports.items()},
        ptxas=regs)
    if "edge_mlp" in reports:
        say("build_edge_mlp", seconds=reports["edge_mlp"]["seconds"],
            kernels=ptxas_table(reports["edge_mlp"]["log"]))

    # 3-4. kernels against their plain versions
    cases, edge_args, fwd = kernel_phase(device)
    bwd = kernel_bwd_phase(device, cases, edge_args)

    # 5. main path: evaluate
    import numpy as np
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import predict as predict_cli
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)
    from deepmetv2_tpu_torch.utils import artifacts

    work = os.path.join(HERE, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    ck = ckpt_copy(work, "ckpts")
    window_max.launches = window_max_bwd.launches = 0
    t = time.perf_counter()
    metrics = evaluate_cli.run(["--synthetic", "2000", "--ckpts", ck,
                                "--restore_file", "best"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_launches = window_max.launches
    loss = metrics["loss"]
    say("evaluate", loss=loss, golden=GOLDEN_LOSS,
        rel_err=abs(loss - GOLDEN_LOSS) / GOLDEN_LOSS,
        launches=eval_launches, bwd_launches=window_max_bwd.launches,
        seconds=eval_s)
    if not abs(loss - GOLDEN_LOSS) <= LOSS_RTOL * GOLDEN_LOSS:
        fail(f"validation loss {loss} is not within {LOSS_RTOL} of "
             f"{GOLDEN_LOSS}")
    if eval_launches != 2 * 10 or window_max_bwd.launches != 0:
        fail(f"evaluate launched window_max {eval_launches} times, not 20, "
             f"and its backward {window_max_bwd.launches} times, not 0")
    res = artifacts.load(os.path.join(ck, "best.resolutions"))
    if "MET" not in res:
        fail("best.resolutions holds no MET entry")

    # 6. main path: predict
    out = os.path.join(work, "pred.npz")
    window_max.launches = 0
    t = time.perf_counter()
    predict_cli.main(["--synthetic", "2000", "--ckpts", ck, "--out", out])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t
    pred_launches = window_max.launches
    z = np.load(out)
    say("predict", events=int(len(z["met"])), launches=pred_launches,
        seconds=pred_s, met_mean=float(np.mean(z["met"])))
    check_predictions(z, "predict")
    if pred_launches != 2 * 50:
        fail(f"predict launched window_max {pred_launches} times, not 100")

    # 7. resume from the JAX checkpoint, held to the JAX losses; replayed
    # chains against eager steps
    train_resume_phase(device)
    chain_replay_phase(device, "graphmet")

    # 8. main path: the train CLI
    train_fwd, train_bwd = train_phase(work)

    # 8b. neighbor_list mode: evaluate, predict, --from_torch in both modes,
    # resumed chained steps, the train CLI
    nl_loss = nl_evaluate_phase(work)
    nl_predict_phase(work)
    from_torch_phase(work, metrics["loss"], nl_loss)
    nl_train_resume_phase(device)
    nl_train_phase(work)

    # 9-10. the DRN's kernels against their plain versions
    drn, drn_cfg = drn_model(device)
    drn_batch = to_device(next(iter(drn_val_loader(drn_cfg, DRN_B))), device)
    (h_a, _), knn = kernel_knn_phase(device, drn, drn_batch)
    emlp = kernel_edge_mlp_phase(device, drn, h_a, drn_batch.mask)
    del h_a, drn_batch

    # 11-12. main path: the DRN's evaluate and predict
    drn_eval = evaluate_drn_phase(device, work, drn, drn_cfg)
    drn_pred = predict_drn_phase(work)

    # 13. where one evaluation step's and one train step's time goes
    profile_phase(device, ck)
    nl_profile(device)
    drn_profile(device, drn, drn_cfg)

    # 14. the DRN's edge-MLP backward kernel against its plain version
    emlp_bwd = kernel_edge_mlp_bwd_phase(device, drn)

    # 15-16. main path: DRN training, resumed from the JAX checkpoint, then
    # the train CLI
    drn_t, drn_opt, drn_tcfg = drn_train_resume_phase(device, drn_cfg)
    chain_replay_phase(device, "drn")
    drn_train = drn_train_phase(work)

    # 16b. the DRN's composed graph build and gather-reduce conv, held to
    # the JAX package's composed path; the mirror gather's backward
    drn_composed_phase(device)

    # 17. the revolver probe's kernel
    probe_launches, probe = probe_phase(device)

    # 18. where one DRN train step's time goes; then an epoch of each family
    # under per-step dispatch and under chained resident replay
    drn_train_profile(device, drn_t, drn_opt, drn_tcfg)
    feed_profile(device, "graphmet")
    feed_profile(device, "drn")

    def runs(name):
        return drn_eval[name] + drn_pred[name] + drn_train[name]

    say("run", seconds=time.perf_counter() - t_run, card=CARD)
    src = "deepmetv2_tpu_torch/csrc/"
    print(json.dumps({"kernels": [dict({
        "name": "window_max_fwd", "route": "cuda",
        "source": src + "window_max.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/edgeconv_window.py:82",
        "launches": eval_launches + pred_launches + train_fwd,
        "library_ms": None}, **fwd), dict({
        "name": "window_max_bwd", "route": "cuda",
        "source": src + "window_max.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/edgeconv_window.py:143",
        "launches": train_bwd, "library_ms": None}, **bwd), dict({
        "name": "knn_kth", "route": "cuda", "source": src + "knn_und.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/knn_und.py:88",
        "launches": runs("knn_kth"), "library_ms": None}, **knn[0]), dict({
        "name": "knn_extract", "route": "cuda", "source": src + "knn_und.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/knn_und.py:109",
        "launches": runs("knn_extract"), "library_ms": None}, **knn[1]),
        dict({
            "name": "edge_mlp_fwd", "route": "cuda",
            "source": src + "edge_mlp.cu",
            "replaces": "deepmetv2_tpu/ops/pallas/edge_mlp.py:93",
            "launches": runs("edge_mlp_fwd"), "library_ms": None},
            **emlp), dict({
            "name": "edge_mlp_bwd", "route": "cuda",
            "source": src + "edge_mlp.cu",
            "replaces": "deepmetv2_tpu/ops/pallas/edge_mlp.py:121",
            "launches": drn_train["edge_mlp_bwd"], "library_ms": None},
            **emlp_bwd), dict({
            "name": "window_max_fwd_pipelined", "route": "cuda",
            "source": src + "window_max.cu",
            "replaces": "scripts/window_revolver_probe.py:37",
            "launches": probe_launches, "library_ms": None}, **probe)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
