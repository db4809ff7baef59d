#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (deepmetv2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one line:
  1. device: the card, and its name and power limit from nvidia-smi;
  2. build: every CUDA kernel source in csrc/, one nvcc each, in parallel;
  3. kernel: window_max forward against its plain PyTorch version, bitwise,
     on (a) the evaluation shape, (b) clustered eta with value ties and
     pairs on the radius boundary, (c) padded nodes and empty events; with
     the kernel's time, the plain version's and the card's lower bound, at
     the evaluation shape and at the training shape (cell order, halo 192);
  4. kernel_bwd: window_max backward against its plain version, bitwise, on
     the same cases (every tied source takes the full gradient), the
     gradients of x, w and b through the EdgeConv wrapper against the plain
     path, and the backward's time at the training shape;
  5. evaluate: the port's evaluate CLI on 2000 synthetic events with the
     committed JAX weights (ckpts_syn/best.ckpt), held to the JAX package's
     validation loss, with the kernels' launches counted;
  6. predict: the port's predict CLI over the same 2000 events;
  7. train_resume: 10 train steps from ckpts_syn/best.ckpt (weights,
     BatchNorm state, AdamW moments, scheduler), each loss held to the JAX
     package's;
  8. train: the port's train CLI, 2 epochs on synthetic 2000 and a resume
     to 3, with the exact launch counts, the artifacts, and its best.ckpt
     re-evaluated by the evaluate CLI;
  9. kernel_knn: the DRN's graph kernels knn_kth and knn_extract against
     their plain versions, bitwise (t, idx, d2v, rel), on (a) the DRN's
     own round-1 features of an evaluation batch (B=40, N=2048, H=64,
     k=16, cap 32), (b) lattice features with many equal distances, (c)
     padded rows, an empty and a 3-node event at N=1536; with both
     kernels' times at N=2048 and N=1536, the plain versions' and the
     bounds;
 10. kernel_edge_mlp: edge_mlp_fwd against its plain version for add,
     mean and max on the graph of (a), within GRAD_RTOL/GRAD_ATOL, and
     its time at the evaluation shape;
 11. evaluate_drn: the evaluate CLI with --model drn on 2000 synthetic
     events at batch 8 (ckpts_syn_drn/best.ckpt), exact launch counts,
     the loss against a second pass over the same batches, and every
     event's MET and graph decisions against the JAX package's fused path
     (GOLDEN_DRN_MET, GOLDEN_DRN_GRAPHS): only events whose graphs differ
     may be off;
 12. predict_drn: the predict CLI with --model drn over the 2000 events;
 13. profile: one evaluation step's and one train step's device time by
     kernel (torch.profiler), and one DRN evaluation step's;
then a JSON line of every ported kernel and, last, the device JSON line.
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


def padded_pos(etaphi, mask):
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import PAD_POS

    return torch.where(mask[..., None], etaphi, torch.full_like(etaphi, PAD_POS))


def isolated_pos(etaphi, mask):
    """Padded rows each at its own far coordinate: they then have no
    neighbours, which isolates what they cost a kernel."""
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import PAD_POS

    B, N, _ = etaphi.shape
    far = PAD_POS + 1000.0 * torch.arange(N, device=etaphi.device,
                                          dtype=torch.float32)
    return torch.where(mask[..., None], etaphi,
                       far[None, :, None].expand(B, N, 2))


def batch_etaphi(batch):
    import torch

    phi = torch.atan2(batch.x_cont[..., 1], batch.x_cont[..., 0])
    return torch.stack([batch.x_cont[..., 3], phi], dim=-1)


def train_shape_batch(device):
    """A cell-sorted batch at the training shape: 8 synthetic events padded
    to N=2048, in the train CLI's order."""
    from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device
    from deepmetv2_tpu_torch.data.sorting import cell_sort_batch

    host = cell_sort_batch(collate(synthetic_events(TRAIN_B, seed=7),
                                   pad_to=TRAIN_N), r=R)
    return to_device(host, device)


def kernel_phase(device):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device
    from deepmetv2_tpu_torch.data.sorting import sort_by_eta
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
        window_edgeconv_linear_cuda, window_max)
    from deepmetv2_tpu_torch.ops.window import (WindowGraph,
                                                window_edgeconv_linear,
                                                window_max_torch)

    rng = np.random.default_rng(0)
    r2 = R ** 2
    B, N, H, halo = 40, 2048, 32, 128

    def check(name, c, pos, halo):
        ones = torch.ones(c.shape[:2], dtype=torch.bool, device=c.device)
        m = window_max(c, pos, r2, halo)
        t = window_max_torch(c, pos, ones, r2, halo)
        torch.cuda.synchronize()
        if not bitwise_equal(m, t):
            fail(f"window_max case {name}: {n_differ(m, t)} entries differ "
                 "from the plain version")
        fin = torch.isfinite(t)
        return float((m[fin] - t[fin]).abs().max()) if fin.any() else 0.0

    # (a) evaluation shape: an eta-sorted synthetic batch
    batch = to_device(collate(synthetic_events(B, seed=7), pad_to=N), device)
    batch, _ = sort_by_eta(batch)
    etaphi = batch_etaphi(batch)
    pos_a = padded_pos(etaphi, batch.mask)
    c_a = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32),
                          device=device)
    errs = [check("a", c_a, pos_a, halo)]

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
    mask_c = batch.mask & torch.as_tensor(
        np.arange(N)[None, :] < nv[:, None], device=device)
    pos_c = padded_pos(etaphi, mask_c)
    errs.append(check("c", c_a, pos_c, halo))
    x = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32),
                        device=device)
    w = torch.as_tensor(rng.normal(size=(2 * H, H)).astype(np.float32) * 0.1,
                        device=device)
    bias = torch.as_tensor(rng.normal(size=(H,)).astype(np.float32),
                           device=device)
    g = WindowGraph(etaphi, mask_c, r=R, halo=halo)
    with torch.no_grad():
        out_k = window_edgeconv_linear_cuda(x, g, w, bias)
        out_t = window_edgeconv_linear(x, g, w, bias)
    if not bitwise_equal(out_k, out_t):
        fail("window_edgeconv_linear_cuda differs from the plain version")
    if bool((out_k[~mask_c] != 0).any()):
        fail("window_edgeconv_linear_cuda is not 0 at padded nodes")

    ones = torch.ones(B, N, dtype=torch.bool, device=device)
    ms = cuda_ms(lambda: window_max(c_a, pos_a, r2, halo), 50)
    plain_ms = cuda_ms(lambda: window_max_torch(c_a, pos_a, ones, r2, halo), 5)
    pos_iso = isolated_pos(etaphi, batch.mask)
    isolated_ms = cuda_ms(lambda: window_max(c_a, pos_iso, r2, halo), 50)
    pairs, adj = window_work(pos_a, batch.mask, halo, r2)
    nbytes = 4 * (c_a.numel() + pos_a.numel() + c_a.numel())
    ops = 6 * pairs + H * adj     # predicate: 2 sub, 2 mul, add, compare
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)

    # the training shape: cell order, halo 192, 8 events
    tb = train_shape_batch(device)
    tpos = padded_pos(batch_etaphi(tb), tb.mask)
    tc = torch.as_tensor(rng.normal(size=(TRAIN_B, TRAIN_N, H))
                         .astype(np.float32), device=device)
    t_ms = cuda_ms(lambda: window_max(tc, tpos, r2, TRAIN_HALO), 50)
    t_iso = isolated_pos(batch_etaphi(tb), tb.mask)
    t_iso_ms = cuda_ms(lambda: window_max(tc, t_iso, r2, TRAIN_HALO), 50)
    t_pairs, t_adj = window_work(tpos, tb.mask, TRAIN_HALO, r2)
    t_bound = bound(4 * (2 * tc.numel() + tpos.numel()),
                    6 * t_pairs + H * t_adj)
    say("kernel", name="window_max_fwd", cases="a,b,c bitwise equal",
        shape=[B, N, H], halo=halo, real_rows=int(batch.mask.sum()),
        ms=ms, plain_ms=plain_ms, padded_rows_isolated_ms=isolated_ms,
        bytes=nbytes, window_pairs=pairs, adjacent_pairs=adj, fp32_ops=ops,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
        train_shape=[TRAIN_B, TRAIN_N, H], train_halo=TRAIN_HALO,
        train_real_rows=int(tb.mask.sum()), train_ms=t_ms,
        train_padded_rows_isolated_ms=t_iso_ms, train_window_pairs=t_pairs,
        train_adjacent_pairs=t_adj, train_bound_ms=t_bound[0])
    cases = {"a": (c_a, pos_a, halo), "b": (c_b, pos_b, 192),
             "c": (c_a, pos_c, halo)}
    return cases, (x, g, w, bias), {
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by}


def kernel_bwd_phase(device, cases, edge_args):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
        window_edgeconv_linear_cuda, window_max, window_max_bwd)
    from deepmetv2_tpu_torch.ops.window import (window_edgeconv_linear,
                                                window_max_bwd_torch)

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
    tb = train_shape_batch(device)
    etaphi = batch_etaphi(tb)
    pos = padded_pos(etaphi, tb.mask)
    H = x.shape[-1]
    c = torch.as_tensor(rng.normal(size=(TRAIN_B, TRAIN_N, H))
                        .astype(np.float32), device=device)
    m = window_max(c, pos, r2, TRAIN_HALO)
    gr = torch.as_tensor(rng.normal(size=tuple(c.shape)).astype(np.float32),
                         device=device) * tb.mask[..., None]   # 0 at padding
    ms = cuda_ms(lambda: window_max_bwd(c, pos, m, gr, r2, TRAIN_HALO), 50)
    plain_ms = cuda_ms(
        lambda: window_max_bwd_torch(c, pos, m, gr, r2, TRAIN_HALO), 3)
    pos_iso = isolated_pos(etaphi, tb.mask)
    m_iso = window_max(c, pos_iso, r2, TRAIN_HALO)
    iso_ms = cuda_ms(
        lambda: window_max_bwd(c, pos_iso, m_iso, gr, r2, TRAIN_HALO), 50)
    pairs, adj = window_work(pos, tb.mask, TRAIN_HALO, r2)
    nbytes = 4 * (4 * c.numel() + pos.numel())       # c, m, g, dc; pos
    ops = 6 * pairs + 2 * H * adj   # predicate; compare and add per feature
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
    say("kernel_bwd", name="window_max_bwd", cases="a,b,c bitwise equal",
        extra_tied_sources=ties, edgeconv_grad_max_abs_err=grad_err,
        shape=[TRAIN_B, TRAIN_N, H], halo=TRAIN_HALO,
        real_rows=int(tb.mask.sum()), ms=ms, plain_ms=plain_ms,
        padded_rows_isolated_ms=iso_ms, bytes=nbytes, window_pairs=pairs,
        adjacent_pairs=adj, fp32_ops=ops, bound_bytes_ms=t_bytes,
        bound_ops_ms=t_ops)
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def step_profile(step, reps: int = 5):
    """(device ms per step, kernels per step, top kernels) of ``step``
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
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
    GOLDEN_TRAIN_LOSSES (a lost AdamW count or moment shows at step 2)."""
    import dataclasses
    import itertools

    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
    from deepmetv2_tpu_torch.train.step import (make_optimizer,
                                                make_train_step)

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
    step = make_train_step(cfg)
    losses = [float(step(model, opt, to_device(b, device)))
              for b in itertools.islice(iter(ld), len(GOLDEN_TRAIN_LOSSES))]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, GOLDEN_TRAIN_LOSSES)]
    say("train_resume", epoch=payload["epoch"], adam_count=payload["step"],
        sched_best=sched.best, losses=losses, golden=GOLDEN_TRAIN_LOSSES,
        max_rel_err=max(rel))
    if not max(rel) <= LOSS_RTOL:
        fail(f"resumed train losses are not within {LOSS_RTOL} of the JAX "
             f"package's: {losses}")


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
                 if ln.startswith(("graph mode", "Training epoch", "- Eval",
                                   "Restarting"))]
        say("train", argv=argv, seconds=sec, fwd_launches=window_max.launches,
            bwd_launches=window_max_bwd.launches, log=lines)
        if rc != 0:
            fail(f"train CLI {argv} exited {rc}")
        if f"graph mode: window (halo {TRAIN_HALO}, order cell)" not in text:
            fail(f"train CLI did not print halo {TRAIN_HALO}, order cell")
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


def drn_eval_pass(model, loader, device):
    """The DRN's validation pass as the evaluate CLI takes it, with what the
    CLI does not return: ``(losses, met, graphs)``, the per-batch losses, the
    cartesian MET estimate of every event ``[n, 2]`` in the loader's order
    and its per-round graph digests ``[n, rounds]``."""
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
            pred = drn_net_apply(model.eval(), batch, diag)
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


def kernel_knn_phase(device, model, batch):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_extract, knn_kth
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
            real_rows=int(m.sum()), kth_bound=kb, extract_bound=eb)
    say("kernel_knn", names=["knn_kth", "knn_extract"],
        cases="a,b,c bitwise equal (t, idx, d2v, rel)", shape=[B, N, H],
        k=k, cap=cap, real_rows=int(mask_a.sum()),
        rows_past_cap_a=cap_rows, max_degree_a=int(deg[mask_a].max()),
        equal_adjacent_slots_b=ties, times=times)
    tk, te = times[N], times[N]
    return (h_a, t_a), [
        {"max_abs_err": max(errs), "ms": tk["kth_ms"],
         "plain_ms": tk["kth_plain_ms"], "bound_ms": tk["kth_bound"][0],
         "bound_by": tk["kth_bound"][1]},
        {"max_abs_err": max(errs), "ms": te["extract_ms"],
         "plain_ms": te["extract_plain_ms"],
         "bound_ms": te["extract_bound"][0],
         "bound_by": te["extract_bound"][1]}]


def kernel_edge_mlp_phase(device, model, h, mask):
    """edge_mlp_fwd against its plain version on the DRN's round-1 graph of
    the evaluation batch (padded query rows have no valid slot), for each
    aggregation, and its time at that shape."""
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edge_mlp import edge_mlp_fwd
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph
    from deepmetv2_tpu_torch.ops.edge_mlp import edge_mlp_fwd_torch

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
    B, N, K = nbr.mask.shape
    edges = int(nbr.mask.sum())
    with torch.no_grad():
        ms = cuda_ms(lambda: edge_mlp_fwd(*args, "add"), 20)
        plain_ms = cuda_ms(lambda: edge_mlp_fwd_torch(*args, "add"), 3)
    nbytes = 4 * (a.numel() + h.numel() + nbr.idx.numel() + w_diff.numel()
                  + w1.numel() + b1.numel() + B * N * H2 + 2 * H2) \
        + nbr.mask.numel()
    ops = 2 * (H * F1 + F1 * H2) * edges
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
    say("kernel_edge_mlp", name="edge_mlp_fwd",
        cases="add,mean,max within rtol 1e-5 + 2e-6 max|plain|",
        max_abs_err=max(errs), shape=[B, N, K, H, F1, H2],
        valid_edges=edges, empty_rows=empty, ms=ms, plain_ms=plain_ms,
        bytes=nbytes, fp32_ops=ops, bound_bytes_ms=t_bytes,
        bound_ops_ms=t_ops)
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

    ck = os.path.join(work, "drn")
    os.makedirs(ck)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(HERE, DRN_CKPTS, f), ck)
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
    gold = np.load(os.path.join(HERE, GOLDEN_DRN_MET))
    gold_graphs = np.load(os.path.join(HERE, GOLDEN_DRN_GRAPHS))
    gen = np.stack([np.asarray(ld.dataset[int(i)][1][:2])
                    for i in np.concatenate(ld._batches)])
    if met.shape != gold.shape or graphs.shape != gold_graphs.shape:
        fail(f"DRN evaluate: {met.shape} / {graphs.shape} events checked, "
             f"the JAX package's files hold {gold.shape} / "
             f"{gold_graphs.shape}")
    differs = graphs != gold_graphs                        # [events, rounds]
    diverged = differs.any(axis=1)
    dev = np.abs(met - gold).max(axis=1)
    scale = np.maximum(np.abs(gold).max(axis=1), 1.0)
    off = dev > DRN_EVENT_RTOL * scale
    per_t = 0.5 * ((met - gen) ** 2).sum(1)
    per_j = 0.5 * ((gold - gen) ** 2).sum(1)
    kept_rel = (abs(per_t[~diverged].mean() - per_j[~diverged].mean())
                / per_j[~diverged].mean())
    say("evaluate_drn", loss=loss, golden=GOLDEN_DRN_LOSS,
        rel_err=abs(loss - GOLDEN_DRN_LOSS) / GOLDEN_DRN_LOSS,
        jax_tpu_run_loss_not_a_gate=JAX_TPU_DRN_LOSS, launches=launches,
        window_max_launches=window_max.launches, seconds=sec,
        checked_pass_loss=pass_loss, cli_rel_err=cli_rel,
        events=int(len(met)), graph_events=int(diverged.sum()),
        graph_events_by_round=[int(c) for c in differs.sum(axis=0)],
        events_off=int(off.sum()),
        off_events=[int(i) for i in np.flatnonzero(off)],
        off_max_abs_met=float(dev[off].max()) if off.any() else 0.0,
        kept_events=int((~diverged).sum()),
        kept_max_rel_met=float((dev / scale)[~diverged].max()),
        kept_loss_rel_err=float(kept_rel))
    want = 2 * len(ld)
    if launches != {k: want for k in counters} or window_max.launches:
        fail(f"DRN evaluate launched {launches} and window_max "
             f"{window_max.launches} times; want {want} each and 0")
    if not cli_rel <= DRN_CLI_RTOL:
        fail(f"DRN evaluate CLI loss {loss} is {cli_rel} from the checked "
             f"pass's {pass_loss}, not within {DRN_CLI_RTOL}")
    if (off & ~diverged).any():
        fail(f"DRN evaluate: events {np.flatnonzero(off & ~diverged).tolist()}"
             f" differ from the JAX package's MET by more than "
             f"{DRN_EVENT_RTOL} although their graphs equal its graphs")
    if diverged.sum() > DRN_MAX_GRAPH_EVENTS:
        fail(f"DRN evaluate: {int(diverged.sum())} of {len(met)} events have "
             f"graph decisions unlike the JAX package's; at most "
             f"{DRN_MAX_GRAPH_EVENTS} may (near-ties)")
    if not kept_rel <= DRN_KEPT_RTOL:
        fail(f"DRN evaluate: the loss over the events with the JAX graphs is "
             f"{kept_rel} from the JAX package's, not within {DRN_KEPT_RTOL}")
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


def main() -> int:
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
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    from deepmetv2_tpu_torch.ops.cuda import build
    t = time.perf_counter()
    reports = build.build()
    sec = time.perf_counter() - t
    regs = {k: [ln.split(":", 1)[1].strip() for ln in v.splitlines()
                if "registers" in ln] for k, v in reports.items()}
    say("build", kernels=list(build.KERNELS), seconds=sec, ptxas=regs)

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
    ck = os.path.join(work, "ckpts")
    os.makedirs(ck)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(HERE, "ckpts_syn", f), ck)
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
    w, nv = z["weights"], z["n_valid"]
    real = np.arange(w.shape[1])[None, :] < nv[:, None]
    say("predict", events=int(len(z["met"])), launches=pred_launches,
        seconds=pred_s, met_mean=float(np.mean(z["met"])))
    if len(z["met"]) != 2000 or not np.array_equal(z["event_index"],
                                                   np.arange(2000)):
        fail("predict did not return 2000 events in input order")
    if not np.all(np.isfinite(z["met"])):
        fail("predict returned non-finite MET")
    if not (np.all((w[real] >= 0) & (w[real] <= 1)) and np.all(w[~real] == 0)):
        fail("predict weights outside [0, 1] or nonzero at padding")
    if pred_launches != 2 * 50:
        fail(f"predict launched window_max {pred_launches} times, not 100")

    # 7. resume from the JAX checkpoint, held to the JAX losses
    train_resume_phase(device)

    # 8. main path: the train CLI
    train_fwd, train_bwd = train_phase(work)

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
    drn_profile(device, drn, drn_cfg)

    def runs(name):
        return drn_eval[name] + drn_pred[name]

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
            **emlp)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
