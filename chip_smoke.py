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
  4b. kernel_cat_embed: GraphMET's categorical embedding op at the train
     (8, 8192) and serving (40, 8192) shapes, D=8: its forward bitwise
     against the plain composition, its backward within CAT_EMBED_RTOL of
     a float64 sum and bitwise over three calls, through autograd and
     between an eager call and a captured graph's replay, with device
     times beside the bounds, the plain versions' and torch's index
     backward (library_ms) and the one-hot product's, ``one_hot(idx).T @
     grad`` per table;
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
  8a. etl_data, the real-data path at CMS-scale event sizes: (a) the
     chunks of ETL_CHUNKS (etl_chunk: 500-5000 candidates per event, a
     central eta core) through the ETL CLI in both modes, each slice's
     arrays against GOLDEN_ETL_DIGESTS; (b) window_max_fwd and
     window_max_bwd bitwise against their plain versions on the largest
     cell-sorted train batch (N=8192, the train CLI's halo
     GOLDEN_ETL_TRAIN_HALO), with times, bounds and kept chunks; (c) the
     evaluate CLI on the slices within LOSS_RTOL of GOLDEN_ETL_LOSS, its
     halo GOLDEN_ETL_HALO, exact launches; (d) 10 chained steps resumed
     from ckpts_syn/best.ckpt on the first 10 cell-sorted train batches,
     each within LOSS_RTOL of GOLDEN_ETL_TRAIN_LOSSES; (e) the train CLI
     for 1 epoch (its "feed:" and "graph mode:" lines, exact launches with
     replays), best.ckpt re-evaluated within REEVAL_RTOL; (f) one train
     and one evaluation step at N=8192 profiled, and the host's seconds
     for collating, cell sort and halo sizing;
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
  8c. bf16 compute (ckpts_syn_bf16, ModelConfig.compute_dtype bfloat16):
     kernel_bf16, the bf16 instantiations of the window forward and
     backward against their plain versions on bf16 tensors, bitwise on
     every row, at the evaluation and training shapes, H in {8, 33, 64,
     128}, padded blocks and an all-padded event, lattice values with
     ties, with their times and bounds; bf16_evaluate, the evaluate CLI on
     synthetic 2000 within BF16_LOSS_RTOL of GOLDEN_BF16_LOSS with 20 bf16
     launches and no f32 window launch; bf16_train_resume, 10 chained
     steps from ckpts_syn_bf16/best.ckpt each within BF16_TRAIN_RTOL of
     GOLDEN_BF16_TRAIN_LOSSES; bf16_train, the train CLI with
     --compute_dtype bfloat16 for 1 epoch (its "feed:" line, exact bf16
     launch counts with replays), its best.ckpt re-evaluated within
     REEVAL_RTOL;
  8d. the mesh (parallel/), two ranks sharing the card through gloo
     (collectives staged through host copies), spawned once:
     mesh_dp_train (--mesh 2) and mesh_ep_train (--mesh 1x2), 10 steps
     resumed from ckpts_syn/best.ckpt as mesh chains of 8 and 2, each loss
     within LOSS_RTOL of GOLDEN_TRAIN_LOSSES, the exact f32 window
     launches on each rank; mesh_ep_kernel, the sharded window max on one
     full-width batch bitwise the single-device kernel on real rows, its
     gradient within GRAD_ATOL of the largest; mesh_evaluate (--mesh 2),
     the evaluate CLI's pass within LOSS_RTOL of GOLDEN_LOSS, and the DRN's
     (composed, the JAX mesh path) held by drn_golden_rule to
     GOLDEN_DRN_COMPOSED_*; mesh_drn_ep, the node-sharded DRN on the same
     two ranks (--model drn --mesh 1x2, ckpts_syn_drn at full width), one
     line per sub-phase: knn, both distributed kNN builds at B=8, N=2048,
     H=64 against the single-device knn_graph (sets equal on rows without
     a tie at the k-th place, the builds bitwise on rows without a tie,
     the ties counted), evaluate, the eval forward over the 400
     validation events held by drn_golden_rule to GOLDEN_DRN_COMPOSED_*
     (round-2 digests in the compacted labelling), ring, its first
     batches again with the ring build (MET bitwise where the graphs
     agree), train, 10 steps resumed from ckpts_syn_drn/best.ckpt at batch
     16 against the port's single-device composed steps (step 0 within
     DRN_EP_STEP0_RTOL where the graphs agree, then DRN_TRAIN_LATE_RTOL;
     the ranks' losses equal; step times on the host clock,
     the last step traced by utils/profiling.trace), train_replay, every
     step's loss and model within DRN_EP_REPLAY_RTOL of the single-device
     step on the sharded step's own graphs, launches, the fused conv's
     kernels (edge_mlp_fwd, edge_mlp_bwd) two per forward and no graph
     kernel on any of these; then mesh_world1 (--mesh 1 on NCCL in this
     process), 3 steps bitwise the single-device step's; mesh_cli, the train
     CLI with --mesh 1x2 for 1 epoch (it spawns its ranks), each rank's
     exact launches, best.ckpt re-evaluated within REEVAL_RTOL; and
     mesh_drn_ep's cli, the train CLI with --model drn --mesh 1x2
     --ring_knn for 1 epoch, the fused conv's kernels alone launched,
     best.ckpt re-evaluated within REEVAL_RTOL on the path the mesh
     evaluates with;
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
     kernel (torch.profiler), in f32 and in bf16, the same in neighbor_list
     mode with the radius build, the gather and its backward timed alone,
     and one DRN evaluation step's;
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
 16c. kernel_pn_edge: ParticleNet's kernels at the cell
     particlenet-train-cms's shapes (16 events of 500-5000 real
     candidates at N=8192, k=16): the directed and the undirected
     extraction and knn_kth bitwise against their plain versions at H = 2,
     64, 128; the edge block (csrc/pn_edge.cu) at each block's widths,
     forward, statistics and every gradient within PN_EDGE_RTOL of the
     plain version in float64 (on the first PN_CHECK_B events; the
     gradients with BatchNorm shifts of +-PN_SHIFT, no ReLU input near
     zero, and printed with shifts near 0), a second
     call and a graph replay bitwise; pn_edge_fwd's and pn_edge_bwd's
     device times at the widest block beside their bounds and the plain
     version's, and at half the real candidates (the work follows the real
     edges: at most PN_HALF_MAX of the full time); pn_train: the train CLI
     with --model particlenet, 2 epochs and a resume to 3, exact launch
     counts of the directed kNN and the edge block (replays included),
     finite losses falling from epoch 1 to 2, best.ckpt re-evaluated by
     the evaluate CLI (its launches counted too);
 17. probe: the pipelined window forward (the TPU revolver probe's port)
     bitwise against window_max_fwd and the plain version at both probe
     shapes, with times;
 18. profile: one DRN train step's device time by kernel; feed: for each
     family, one epoch of synthetic 2000 under per-step dispatch with a
     copy of each batch and under chained resident replay: ms per step,
     device ms per step and the idle share, beside the card's name and
     power limit;
then the whole run's seconds, a JSON line of every ported kernel (and the
cat_embed and pn_edge kernels, which replace none; their launches are
those of the main-path phases that check them, one forward a batch (three
for pn_edge) and one backward a train step (three)) and, last, the device
JSON line.
Any failed check exits non-zero before the last line.  Writes only under
build/ in the checkout.
"""

from __future__ import annotations

import contextlib
import functools
import io
import itertools
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
# bf16 compute (ckpts_syn_bf16: ModelConfig.compute_dtype 'bfloat16'), from
# the JAX package on the CPU forced onto its Pallas path in interpret mode
# (its CPU default ignores compute_dtype):
# tests/test_torch_bf16.py:jax_bf16_eval_loss(), cli.evaluate --synthetic
# 2000 --restore_file best on a copy of ckpts_syn_bf16 (400 validation
# events at batch 40); the port's CPU run gives 1.0300490856170654 (1.2e-7
# apart), so the gate is LOSS_RTOL's.  The same run on a TPU recorded
# 1.0301765203475952 (metrics_val_best.json): printed, not a gate.
GOLDEN_BF16_LOSS = 1.030049204826355
JAX_TPU_BF16_LOSS = 1.0301765203475952
BF16_LOSS_RTOL = 1e-4
# tests/test_torch_bf16.py:jax_bf16_resume_losses(10): make_train_step from
# ckpts_syn_bf16/best.ckpt on the first 10 cell-sorted train batches of
# synthetic 2000 (seed 42, batch 8, halo 192), on the same forced path.  The
# port's CPU steps (port_bf16_resume_losses(10)) are within 3.0e-5 of them
# (step 9; the others within 3.8e-6): the gate is ten times that.
GOLDEN_BF16_TRAIN_LOSSES = (
    1.4477107524871826, 0.5382652282714844, 1.4119887351989746,
    0.5942192077636719, 0.8778863549232483, 0.9048249125480652,
    0.6520813703536987, 0.6070807576179504, 1.1554502248764038,
    0.6632782220840454)
BF16_TRAIN_RTOL = 3e-4
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

# ParticleNet at the cell particlenet-train-cms's shapes: 16 events of
# 500-5000 real candidates at N=8192, k=16, blocks of (Cin, C) = (11, 64),
# (64, 128), (128, 256).  The float64 check runs on the first PN_CHECK_B
# events: the plain version keeps about four tensors of B·N·k·C doubles a
# layer for its backward (the phase's peak reads 33 GB on the card).
PN_B, PN_N, PN_K, PN_CHECK_B = 16, 8192, 16, 8
PN_WIDTHS = ((11, 64), (64, 128), (128, 256))
# the edge block's output, statistics and gradients against the plain
# version in float64, the largest gap over the largest magnitude.  On an H100
# 80GB HBM3 at 700 W at these shapes the kernels read up to 9.2e-6 (dw3, a
# sum over ~200k edges) and the plain version in float32 up to 1.3e-5: five
# times the kernels' reading.  ReLU's derivative jumps at zero: of ~10^7
# ReLU inputs a few lie within float32's rounding of it, float32 and
# float64 decide them differently, and each such decision moves the
# gradients upstream of it by a whole term (on the same card with
# BatchNorm shifts near 0: dx 5e-3 to 9e-3 of its largest, the plain
# version in float32 alike, y 1.5e-7 to 3.5e-7).  So the gradients are held
# to it where every BatchNorm shift is +-PN_SHIFT (by channel) and no ReLU
# input lies within KINK of zero (counted from the kernel's own
# pre-activations); with shifts near 0, as in training, the output and
# statistics are held and the gradients printed beside the plain
# version's own float32 gap.
PN_EDGE_RTOL = 5e-5
PN_SHIFT = 5.0
# fwd+bwd device time at half the real candidates over the full time: the
# work follows the real edges, so about 0.5 (0.551 in the probe,
# PERF.md's kernel table); 20 % above a half
PN_HALF_MAX = 0.6
PN_TRAIN_B, PN_TRAIN_EVENTS = 16, 400   # train CLI: 20 steps, 5 evaluations

# The etl_data phase: NanoAOD-shaped chunks from etl_chunk, through the
# port's ETL CLI (two dytt chunks of 250 events and one znunu chunk of 100,
# seeds ETL_SEED + i), into the real-data path at CMS-scale event sizes.
ETL_SEED = 1300
ETL_CHUNKS = (("dytt", 250), ("dytt", 250), ("znunu", 100))
ETL_PF = (500, 5001)         # PF candidates per event, integers(lo, hi)
# The JAX package's ETL CLI on those chunks, on the CPU:
# tests/test_torch_etl.py:jax_etl_digests() (numpy 2.0.2)
GOLDEN_ETL_DIGESTS = {
    "dytt_file0_slice_0_nevent_224.npz": (
        "0501d7256bfd8dda5378cf6ea760a4f39fee4b628fa5baa8cd3e3d23390d86fe",
        "e5f2da11fb26be165c4ebd35223d96134d395ba8d64fee0bfdcadfb1ee8da8c0"),
    "dytt_file1_slice_0_nevent_227.npz": (
        "225b1075d129d28eb6c8417e5358c2c72dd69404110907bdc9f4ffd17b291c56",
        "376e8493e7fa5ae5eef8567dcb4852dd7baac11bce8c506a2d16a08d17a45b51"),
    "znunu_file0_slice_0_nevent_100.npz": (
        "904374f1f40cdc9517eb81ffbcde2c04621f0855552051e13ecb47c5efad67c0",
        "9dae24917bf0fca1edf2047248ae4f039ca5a3c0650730c186cd167e6323a11f")}
# The JAX evaluate CLI on those slices with ckpts_syn/best.ckpt (batch 40,
# the halo sized on the whole dataset in eta order), on the CPU:
# tests/test_torch_etl.py:jax_etl_eval_loss()
GOLDEN_ETL_LOSS = 9262.806640625
GOLDEN_ETL_HALO = 512
# The JAX package's train step from ckpts_syn/best.ckpt on the first 10
# cell-sorted train batches of those slices (batch 8, the halo its train
# CLI sizes on both cell-sorted loaders), on the CPU:
# tests/test_torch_etl.py:jax_etl_resume_losses(10).  The port's CPU steps
# (port_etl_resume_losses(10)) are within 2.03e-5 of them (step 5; steps
# 0-4 within 1.9e-6): the gate is LOSS_RTOL's.
GOLDEN_ETL_TRAIN_LOSSES = (
    13798.6259765625, 8941.5322265625, 10586.8916015625, 8121.35595703125,
    5916.4599609375, 3797.9423828125, 7831.9423828125, 16182.400390625,
    11315.0810546875, 14051.0)
GOLDEN_ETL_TRAIN_HALO = 768


def etl_chunk(seed: int, n_events: int, leptons: bool, n_pf=ETL_PF) -> dict:
    """A NanoAOD-shaped chunk in the data model of etl/common.py (ragged
    collections as lists of per-event arrays), numpy only, drawn with
    ``integers``, ``random``, ``uniform`` and ``standard_normal``, whose
    streams numpy keeps from version to version.

    PF candidates: ``integers(*n_pf)`` per event; eta 70 % a central core
    (standard normal x 1.6, clipped to +-5), 30 % uniform in +-5; phi
    uniform; pt Pareto (alpha 2.5, from 0.5 GeV) by its inverse CDF;
    |pdgId| from the classes GraphMET embeds (1, 2, 11, 13, 22, 130, 211)
    with charged ones signed, fromPV 0-3.  With ``leptons``: two muons
    (pt 30-90, |eta| < 2.4, tight and isolated) of which the second fails
    the pt cut in about 10 % of events, 0-1 electrons (pt 15-30, WP80 half
    the time), and PF candidate 0 planted 1e-5 in eta from the leading
    muon, which overlap removal then drops.  The five MET collections
    (pt 0-200) and LHE HT (100-1000)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    pdgs = np.array([1, 2, 11, 13, 22, 130, 211], np.int32)
    charged = np.array([0, 0, 1, 1, 0, 0, 1], np.int32)
    cum = np.cumsum([0.04, 0.04, 0.02, 0.02, 0.25, 0.13, 0.50])[:-1]
    fields = ("pt", "eta", "phi", "d0", "dz", "mass", "puppiWeight",
              "pdgId", "charge", "fromPV", "pvRef", "pvAssocQuality")
    pf = {f: [] for f in fields}
    mu = {f: [] for f in ("pt", "eta", "phi", "tightId", "pfRelIso03_all")}
    el = {f: [] for f in ("pt", "eta", "phi", "mvaFall17V1Iso_WP80")}
    for _ in range(n_events):
        n = int(rng.integers(*n_pf))
        core = rng.random(n) < 0.7
        eta = np.where(core, np.clip(rng.standard_normal(n) * 1.6, -5, 5),
                       rng.uniform(-5, 5, n)).astype(f32)
        phi = rng.uniform(-np.pi, np.pi, n).astype(f32)
        pt = (0.5 * (1.0 - rng.random(n)) ** (-1 / 2.5)).astype(f32)
        cls = np.searchsorted(cum, rng.random(n), side="right")
        sign = (2 * rng.integers(0, 2, n) - 1).astype(np.int32)
        pdg = pdgs[cls] * np.where(charged[cls] == 1, sign, 1)
        pf["pt"].append(pt)
        pf["eta"].append(eta)
        pf["phi"].append(phi)
        pf["d0"].append((rng.standard_normal(n) * 0.05).astype(f32))
        pf["dz"].append((rng.standard_normal(n) * 2.0).astype(f32))
        pf["mass"].append(np.where(cls == 6, 0.13957, np.where(
            cls == 5, 0.49761, 0.0)).astype(f32))
        pf["puppiWeight"].append(rng.random(n).astype(f32))
        pf["pdgId"].append(pdg.astype(np.int32))
        pf["charge"].append(charged[cls] * -sign)
        pf["fromPV"].append(rng.integers(0, 4, n).astype(np.int32))
        pf["pvRef"].append(rng.integers(0, 60, n).astype(np.int32))
        pf["pvAssocQuality"].append(rng.integers(0, 8, n).astype(np.int32))
        if not leptons:
            continue
        mpt = np.sort(30 + 60 * rng.random(2))[::-1].astype(f32)
        if rng.random() >= 0.9:
            mpt[1] = f32(5 + 10 * rng.random())         # fails pt > 20
        mu["pt"].append(mpt)
        mu["eta"].append(rng.uniform(-2.4, 2.4, 2).astype(f32))
        mu["phi"].append(rng.uniform(-np.pi, np.pi, 2).astype(f32))
        mu["tightId"].append(np.ones(2, np.int32))
        mu["pfRelIso03_all"].append((0.1 * rng.random(2)).astype(f32))
        ne = int(rng.integers(0, 2))
        el["pt"].append((15 + 15 * rng.random(ne)).astype(f32))
        el["eta"].append(rng.uniform(-2.5, 2.5, ne).astype(f32))
        el["phi"].append(rng.uniform(-np.pi, np.pi, ne).astype(f32))
        el["mvaFall17V1Iso_WP80"].append(
            rng.integers(0, 2, ne).astype(np.int32))
        eta[0] = mu["eta"][-1][0] + f32(1e-5)   # the leading lepton's twin
        phi[0] = mu["phi"][-1][0]
    chunk = {"PFCands": pf, "LHE": {"HT": rng.uniform(100, 1000, n_events)
                                    .astype(f32)}}
    for coll in ("GenMET", "MET", "PuppiMET", "DeepMETResponseTune",
                 "DeepMETResolutionTune"):
        chunk[coll] = {"pt": rng.uniform(0, 200, n_events).astype(f32),
                       "phi": rng.uniform(-np.pi, np.pi, n_events)
                       .astype(f32)}
    if leptons:
        chunk["Muon"], chunk["Electron"] = mu, el
    return chunk


def etl_array_digest(a) -> str:
    """sha256 of an array's dtype, shape and bytes (np.savez's zip headers
    carry a time, so slices are compared by their arrays)."""
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    return hashlib.sha256(repr((a.dtype.str, a.shape)).encode()
                          + a.tobytes()).hexdigest()


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


def _bits(a):
    """``a``'s bits as integers (16-bit for bfloat16, else 32-bit), with
    -0.0 made +0.0 (adding +0.0 does), so only the sign of a zero is
    forgiven."""
    import torch

    return (a + 0.0).view(torch.int16 if a.dtype == torch.bfloat16
                          else torch.int32)


def bitwise_equal(a, b) -> bool:
    import torch

    return torch.equal(_bits(a), _bits(b))


def n_differ(a, b) -> int:
    return int((_bits(a) != _bits(b)).sum())


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


def window_bytes_bf16(pos, H: int, reads: int) -> int:
    """``window_bytes`` for the bf16 kernels: ``reads`` [B, N, H] bf16
    inputs at the real rows, the whole bf16 output, and pos (8 bytes) at
    the real rows."""
    from deepmetv2_tpu_torch.ops.window import padded_rows

    B, N, _ = pos.shape
    real = int((~padded_rows(pos)).sum())
    return 2 * (reads * H * real + B * N * H) + 8 * real


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


CAT_EMBED_SHAPES = {"train": (8, 8192), "serve": (40, 8192)}
CAT_EMBED_D = 8            # H/4 at H=32, the benchmark's GraphMET
# the table gradients against a float64 sum: the largest gap over the
# largest |gradient|, per table.  float32 sums of 65k-330k terms (a
# thread's run, a block's tree, the blocks in double) keep ~1e-7 of it
CAT_EMBED_RTOL = 1e-6


def cat_embed_codes(rng, B: int, N: int, pdgs, device):
    """x_cat [B, N, 3] int32 as the CMS cells hold them: 500-5000 real
    candidates per event (pdgIds mostly known, of both signs, some
    unknown; charge -1..1 with strays; fromPV -1..8), the rest padded
    zeros; the first event's first rows hold int32's extremes."""
    import numpy as np
    import torch

    n = rng.integers(500, 5001, B)
    known = np.asarray(pdgs)
    shape = (B, N)
    pdg = np.where(rng.random(shape) < 0.9,
                   rng.choice(known, shape) * rng.choice([-1, 1], shape),
                   rng.integers(-3000, 3000, shape))
    x = np.stack([pdg, rng.integers(-2, 3, shape),
                  rng.integers(-1, 9, shape)], -1).astype(np.int32)
    x[np.arange(N)[None, :] >= n[:, None]] = 0
    i32 = np.iinfo(np.int32)
    x[0, :3] = [[i32.max] * 3, [i32.min] * 3, [-211, -1, 9]]
    return torch.as_tensor(x, device=device)


def kernel_cat_embed_phase(device):
    """GraphMET's categorical embedding op (csrc/cat_embed.cu) at the train
    shape (8, 8192) and the serving shape (40, 8192), D=8: the forward
    bitwise against the plain composition; the backward against a float64
    sum within CAT_EMBED_RTOL, bitwise over three calls, through
    ``CatEmbed``'s autograd and between an eager call and a captured
    CUDA graph's replay; each kernel's device time beside its bound, the
    plain versions' and torch's index backward (``index_put_`` with
    accumulate, what autograd of ``w[idx]`` runs; the port never calls
    it) as library_ms; the one-hot product per table (``one_hot(idx).T @
    grad``, a deterministic plain alternative to the backward kernel),
    its gap to float64 and whether three calls agree bitwise.  Returns the
    kernel-line numbers of both."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.config import ModelConfig
    from deepmetv2_tpu_torch.ops.cat_embed import (cat_embed_bwd_torch,
                                                   cat_embed_indices,
                                                   cat_embed_torch)
    from deepmetv2_tpu_torch.ops.cuda.cat_embed import (cat_embed,
                                                        cat_embed_bwd,
                                                        cat_embed_fwd)

    pdgs = ModelConfig.pdgs
    rng = np.random.default_rng(5)
    D, rows = CAT_EMBED_D, (3, len(pdgs), 8)
    w = [torch.as_tensor(rng.normal(size=(r, D)).astype(np.float32),
                         device=device) for r in rows]
    lines = {}
    for shape, (B, N) in CAT_EMBED_SHAPES.items():
        x = cat_embed_codes(rng, B, N, pdgs, device)
        g = torch.as_tensor(rng.normal(size=(B, N, 3 * D)).astype(np.float32),
                            device=device)
        out = cat_embed_fwd(x, *w, pdgs)
        if not bitwise_equal(out, cat_embed_torch(x, *w, pdgs)):
            fail(f"cat_embed_fwd {shape}: "
                 f"{n_differ(out, cat_embed_torch(x, *w, pdgs))} entries "
                 "differ from the plain version")
        grads = [cat_embed_bwd(x, g, rows[1], pdgs) for _ in range(3)]
        ref = cat_embed_bwd_torch(x, g.double(), rows[1], pdgs)
        rel = max(float((k.double() - r).abs().max() / r.abs().max())
                  for k, r in zip(grads[0], ref))
        if not rel <= CAT_EMBED_RTOL:
            fail(f"cat_embed_bwd {shape}: {rel} from the float64 sum")
        if not all(bitwise_equal(a, b) for again in grads[1:]
                   for a, b in zip(grads[0], again)):
            fail(f"cat_embed_bwd {shape}: three calls differ")
        leaves = [t.clone().requires_grad_(True) for t in w]
        cat_embed(x, *leaves, pdgs).backward(g)
        if not all(bitwise_equal(t.grad, k) for t, k in zip(leaves,
                                                             grads[0])):
            fail(f"cat_embed {shape}: CatEmbed's gradients are not "
                 "cat_embed_bwd's")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            cat_embed_bwd(x, g, rows[1], pdgs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = cat_embed_bwd(x, g, rows[1], pdgs)
        graph.replay()
        torch.cuda.synchronize()
        if not all(bitwise_equal(a, b) for a, b in zip(grads[0], captured)):
            fail(f"cat_embed_bwd {shape}: the graph's replay differs from "
                 "the eager call")
        del graph, captured

        idx = [i.reshape(-1).long() for i in cat_embed_indices(x, pdgs)]
        parts = [g[..., t * D:(t + 1) * D].reshape(-1, D) for t in range(3)]

        def library():
            return [torch.zeros((r, D), device=device).index_put_(
                (i,), p, accumulate=True) for r, i, p in zip(rows, idx, parts)]

        def onehot():
            return [torch.nn.functional.one_hot(i, r).to(torch.float32).T @ p
                    for r, i, p in zip(rows, idx, parts)]

        lib = library()
        lib_rel = max(float((k.double() - r).abs().max() / r.abs().max())
                      for k, r in zip(lib, ref))
        oh = [onehot() for _ in range(3)]
        oh_rel = max(float((k.double() - r).abs().max() / r.abs().max())
                     for k, r in zip(oh[0], ref))
        oh_repeat = all(bitwise_equal(a, b) for again in oh[1:]
                        for a, b in zip(oh[0], again))
        nbytes = 4 * B * N * (3 * D + 3)   # grad (or out) and x_cat once
        bwd_bound = bound(nbytes, B * N * 3 * D)
        fwd_bound = bound(nbytes, 0)
        device_ms = {
            "fwd": step_profile(lambda: cat_embed_fwd(x, *w, pdgs), 20,
                                cpu=False)[0],
            "bwd": step_profile(lambda: cat_embed_bwd(x, g, rows[1], pdgs),
                                20, cpu=False)[0],
            "fwd_plain": step_profile(lambda: cat_embed_torch(x, *w, pdgs),
                                      5, cpu=False)[0],
            "bwd_plain": step_profile(
                lambda: cat_embed_bwd_torch(x, g, rows[1], pdgs), 5,
                cpu=False)[0],
            "library": step_profile(library, 5, cpu=False)[0],
            "onehot": step_profile(onehot, 20, cpu=False)[0]}
        call_ms = {
            "fwd": cuda_ms(lambda: cat_embed_fwd(x, *w, pdgs), 50),
            "bwd": cuda_ms(lambda: cat_embed_bwd(x, g, rows[1], pdgs), 50),
            "onehot": cuda_ms(onehot, 50)}
        say("kernel_cat_embed", shape=[B, N, 3 * D], real_rows=int(
            (x != 0).any(-1).sum()), fwd="bitwise equal",
            bwd_rel_to_f64=rel, library_rel_to_f64=lib_rel,
            onehot_rel_to_f64=oh_rel, onehot_repeat_bitwise=oh_repeat,
            bwd_repeat="bitwise equal (3 calls, autograd, graph replay)",
            device_ms=device_ms, call_ms=call_ms, bytes=nbytes,
            fwd_bound_ms=fwd_bound[0], bwd_bound_ms=bwd_bound[0],
            bwd_bound_by=bwd_bound[1], card=CARD)
        lines[shape] = (rel, device_ms, fwd_bound, bwd_bound)
    rel, device_ms, fwd_bound, bwd_bound = lines["train"]
    return ({"max_abs_err": 0.0, "ms": device_ms["fwd"],
             "plain_ms": device_ms["fwd_plain"], "bound_ms": fwd_bound[0],
             "bound_by": fwd_bound[1], "library_ms": None},
            {"rel_err_f64": rel, "ms": device_ms["bwd"],
             "plain_ms": device_ms["bwd_plain"], "bound_ms": bwd_bound[0],
             "bound_by": bwd_bound[1], "library_ms": device_ms["library"]})


def step_profile(step, reps: int = 5, cpu: bool = True):
    """(device ms per step, kernels per step, top kernels) of ``step``
    under torch.profiler (``cpu=False``: the device's activity only).  No
    trace file is written (utils/profiling.trace writes one, and its
    export of a profiled feed epoch lengthens the run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    return kernel_times(prof, reps)


def kernel_times(prof, reps: int = 1):
    """(device ms per step, kernels per step, top kernels) of a finished
    torch.profiler run over ``reps`` steps."""
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
    torch.profiler; the model of ``ck``'s config.json (its compute_dtype
    printed)."""
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
    dtype = cfg.model.compute_dtype
    say("profile", step="eval", compute_dtype=dtype,
        batch=[batch.batch_size, batch.max_nodes], step_ms=step_ms, device_ms=dev_ms, device_busy_share=dev_ms / step_ms,
        device_idle_share=1 - dev_ms / step_ms, kernels_per_step=n_k, top=top)

    ld = fetch_dataloader(events=events, batch_size=TRAIN_B,
                          presort_eta=True, presort_mode="cell")["train"]
    batch = to_device(next(itertools.islice(iter(ld), 1)), device)
    train_step = make_train_step(tcfg)
    step_ms = cuda_ms(lambda: train_step(model, opt, batch), 20)
    dev_ms, n_k, top = step_profile(lambda: train_step(model, opt, batch))
    say("profile", step="train", compute_dtype=dtype,
        batch=[batch.batch_size, batch.max_nodes], step_ms=step_ms, device_ms=dev_ms, device_busy_share=dev_ms / step_ms,
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
    embed_counts(zero=True)
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
    check_embed_counts("train resume", len(hosts), len(hosts))


FEED_LINE = "feed: resident, chain 8, CUDA graphs"   # the config's defaults


def check_feed_line(what: str, text: str) -> None:
    if FEED_LINE not in text.splitlines():
        fail(f"{what} did not print {FEED_LINE!r}")


def graph_mode(text: str):
    """``(halo, {loader: {bucket: batches}}, order)`` from a CLI's "graph
    mode:" line (cli/common.py:graph_mode_line), None where it printed
    none."""
    import re

    m = re.search(r"^graph mode: window \(halo (\d+), batches per bucket "
                  r"(.*), order (.*)\)$", text, re.M)
    if m is None:
        return None
    per = {}
    for part in m.group(2).split(", "):
        name, *counts = part.split(" ")
        per[name] = {int(b): int(n) for b, n in
                     (c.split(":") for c in counts if c != "none")}
    return int(m.group(1)), per, m.group(3)


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
    from deepmetv2_tpu_torch.data import fetch_dataloader
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)

    ck = os.path.join(work, "train")
    base = ["--synthetic", "2000", "--batch_size", str(TRAIN_B), "--ckpts", ck]
    steps, evals, convs = 200, 50, 2          # per epoch: 1600 / 8, 400 / 8
    lds = fetch_dataloader(events=smoke_events(2000), batch_size=TRAIN_B)
    per = {k: lds[k].batches_per_bucket() for k in ("train", "test")}
    fwd = bwd = 0
    for argv, epochs in ((["--epochs", "2"], 2),
                         (["--epochs", "3", "--restore_file", "last"], 1)):
        window_max.launches = window_max_bwd.launches = 0
        embed_counts(zero=True)
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
        gm = graph_mode(text)
        if gm != (TRAIN_HALO, per, "cell"):
            fail(f"train CLI's graph mode line {gm} is not halo "
                 f"{TRAIN_HALO}, {per}, order cell")
        check_feed_line("train CLI", text)
        want_f = epochs * (steps * convs + evals * convs)
        want_b = epochs * steps * convs
        if (window_max.launches, window_max_bwd.launches) != (want_f, want_b):
            fail(f"train CLI {argv}: launches forward {window_max.launches}, "
                 f"backward {window_max_bwd.launches}; want {want_f}, {want_b}")
        check_embed_counts(f"train CLI {argv}", epochs * (steps + evals),
                           epochs * steps)
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


@functools.lru_cache(maxsize=None)
def smoke_events(n: int = 2000):
    """``synthetic_events(n, seed=42)``, generated once in a process (the
    phases that call it only read them)."""
    from deepmetv2_tpu_torch.data import synthetic_events

    return synthetic_events(n, seed=42)


def drn_val_loader(cfg, batch_size: int):
    """The validation loader of synthetic 2000 (seed 42, split 0.2), as the
    evaluate CLI builds it."""
    from deepmetv2_tpu_torch.data import fetch_dataloader

    return fetch_dataloader(events=smoke_events(),
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


def pn_edge_bound(nodes: int, E: int, B: int, N: int, k: int, cin: int,
                  C: int):
    """Bounds of pn_edge_fwd and pn_edge_bwd (portbench/counts/
    particlenet.py): operations over real nodes and edges only, the first
    layer as per-node products, 12·C²·E + 12·Cin·C·n + 3·C·E for both;
    bytes of x, the weights, the lists at the real rows and the whole
    output (and, backward, the cotangent and dx)."""
    weights = 2 * cin * C + 2 * C * C
    fwd_ops = 4 * cin * C * nodes + C * E + 4 * C * C * E
    bwd_ops = 8 * cin * C * nodes + (8 * C * C + 2 * C) * E
    fwd_bytes = 4 * (cin * nodes + weights + B * N * C) + 5 * nodes * k
    bwd_bytes = (4 * (cin * nodes + C * nodes + 2 * weights + B * N * cin)
                 + 5 * nodes * k)
    return bound(fwd_bytes, fwd_ops), bound(bwd_bytes, bwd_ops)


def kernel_pn_edge_phase(device):
    """ParticleNet's kernels at the cell's shapes (PN_B, PN_N, PN_K): the
    directed and undirected extraction bitwise against the plain versions
    at H = 2, 64, 128; the edge block at each block's widths within
    PN_EDGE_RTOL of the plain version in float64 (the gradients where no
    ReLU input lies near zero, PN_SHIFT) and bitwise over two calls and a
    graph replay; pn_edge_fwd's and pn_edge_bwd's device times
    at the widest block beside their bounds, the plain version's (float32,
    autograd) and at half the real candidates.  Returns the kernel-line
    numbers of both wrappers."""
    import torch
    from deepmetv2_tpu_torch.ops.cuda.pn_edge import pn_edge_bwd, pn_edge_fwd
    from deepmetv2_tpu_torch.ops.pn_edge import edge_block_torch
    from deepmetv2_tpu_torch.probes import pn_edge_check as pnc

    counts = pnc.cell_counts(PN_B)
    knn = pnc.check_knn(device, PN_B, PN_N, counts)
    if not all(knn.values()):
        fail(f"kernel_pn_edge: the extraction differs from its plain "
             f"version: {knn}")
    checks, rels = {}, []
    for (cin, C), shift in itertools.product(PN_WIDTHS, (PN_SHIFT, 0.0)):
        got = pnc.check_edge(device, cin, C, PN_CHECK_B, PN_N,
                             counts[:PN_CHECK_B], shift)
        checks[f"{cin}x{C} shift {shift}"] = got
        held = pnc.GAPS if shift else pnc.GAPS[:2]
        rel = {k: got[k] for k in held}
        if not max(rel.values()) <= PN_EDGE_RTOL:
            fail(f"kernel_pn_edge ({cin}, {C}, shift {shift}): {rel}, not "
                 f"within {PN_EDGE_RTOL} of the plain version in float64")
        if shift and got["near_kink"]:
            fail(f"kernel_pn_edge ({cin}, {C}): {got['near_kink']} ReLU "
                 f"inputs within {pnc.KINK} of zero at shift {shift}")
        if not (got["repeat_bitwise"] and got["replay_bitwise"]):
            fail(f"kernel_pn_edge ({cin}, {C}): a second call or the graph "
                 f"replay differs: {got}")
        rels += rel.values()
        torch.cuda.empty_cache()

    cin, C = PN_WIDTHS[-1]
    times = {}
    for name, cs in (("full", counts), ("half", [c // 2 for c in counts])):
        x, pts, mask = pnc.inputs(PN_B, PN_N, cs, cin, device, 7)
        nbr = pnc.lists(pts, mask)
        ws = pnc.weights(cin, C, device, 8)
        gy = torch.randn((PN_B, PN_N, C), device=device) * mask[..., None]
        cnt = torch.tensor(cs, dtype=torch.int32, device=device)
        n_edges = nbr.mask.sum().double().reshape(1)
        gamma, beta = ws[3], ws[4]

        def fwd():
            return pn_edge_fwd(x, nbr, cnt, n_edges, *ws[:3], gamma, beta,
                               True)

        _, z, st, inv_deg = fwd()

        def bwd():
            return pn_edge_bwd(x, nbr, cnt, n_edges, *ws[:3], gamma, z, st,
                               inv_deg, gy)

        t = {"fwd": step_profile(fwd, 5, cpu=False)[0],
             "bwd": step_profile(bwd, 5, cpu=False)[0],
             "real_nodes": sum(cs), "real_edges": int(n_edges)}
        del z, st, inv_deg
        if name == "full":
            t["bounds"] = pn_edge_bound(sum(cs), int(n_edges), PN_B, PN_N,
                                        PN_K, cin, C)
            leaves = [v.clone().requires_grad_(True) for v in [x] + ws]
            with torch.no_grad():
                t["fwd_plain"] = step_profile(lambda: edge_block_torch(
                    leaves[0], nbr, *leaves[1:], True), 2, cpu=False)[0]
            y, _ = edge_block_torch(leaves[0], nbr, *leaves[1:], True)
            t["bwd_plain"] = step_profile(lambda: torch.autograd.grad(
                y, leaves, gy, retain_graph=True), 2, cpu=False)[0]
            del y, leaves
        times[name] = t
        del x, pts, mask, nbr, gy
        torch.cuda.empty_cache()
    full, half = times["full"], times["half"]
    ratio = (half["fwd"] + half["bwd"]) / (full["fwd"] + full["bwd"])
    (fb, fby, _, _), (bb, bby, _, _) = full["bounds"]
    say("kernel_pn_edge", shape=[PN_B, PN_N, PN_K], widths=PN_WIDTHS,
        knn="directed and undirected bitwise at H = 2, 64, 128",
        edge_rel_to_f64=checks, check_events=PN_CHECK_B,
        repeat="bitwise equal (2 calls, graph replay)",
        real_nodes=full["real_nodes"], real_edges=full["real_edges"],
        fwd_ms=full["fwd"], bwd_ms=full["bwd"],
        fwd_plain_ms=full["fwd_plain"], bwd_plain_ms=full["bwd_plain"],
        fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb, bwd_bound_by=bby,
        half_real_nodes=half["real_nodes"], half_fwd_ms=half["fwd"],
        half_bwd_ms=half["bwd"], half_over_full=ratio, card=CARD)
    if not ratio <= PN_HALF_MAX:
        fail(f"kernel_pn_edge: half the real candidates take {ratio} of the "
             f"full time, over {PN_HALF_MAX}: the work does not follow the "
             "real edges")
    rel = max(rels)
    return ({"rel_err_f64": rel, "ms": full["fwd"],
             "plain_ms": full["fwd_plain"], "bound_ms": fb, "bound_by": fby,
             "library_ms": None},
            {"rel_err_f64": rel, "ms": full["bwd"],
             "plain_ms": full["bwd_plain"], "bound_ms": bb, "bound_by": bby,
             "library_ms": None})


def pn_counters():
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_extract, knn_kth
    from deepmetv2_tpu_torch.ops.cuda.pn_edge import pn_edge_bwd, pn_edge_fwd

    return {"knn_kth": knn_kth, "knn_extract": knn_extract,
            "pn_edge_fwd": pn_edge_fwd, "pn_edge_bwd": pn_edge_bwd}


def pn_train_phase(work: str) -> dict:
    """The train CLI with --model particlenet on synthetic PN_TRAIN_EVENTS
    at batch PN_TRAIN_B: 2 epochs and a resume to 3, chained and resident
    (its "feed:" line checked), exact launch counts of the directed kNN and
    the edge block (three blocks a batch, replays included), finite losses
    falling from epoch 1 to 2, the artifacts, and best.ckpt re-evaluated by
    the evaluate CLI within REEVAL_RTOL, its launches counted.  Returns
    each wrapper's launches over the three runs."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import train as train_cli

    ck = os.path.join(work, "pn_train")
    base = ["--model", "particlenet", "--synthetic", str(PN_TRAIN_EVENTS),
            "--batch_size", str(PN_TRAIN_B), "--ckpts", ck]
    steps = int(PN_TRAIN_EVENTS * 0.8) // PN_TRAIN_B
    evals = int(PN_TRAIN_EVENTS * 0.2) // PN_TRAIN_B
    counters = pn_counters()
    total = {k: 0 for k in counters}

    def counted(what, run, fwd, bwd):
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {"knn_kth": 3 * fwd, "knn_extract": 3 * fwd,
                "pn_edge_fwd": 3 * fwd, "pn_edge_bwd": 3 * bwd}
        if launches != want:
            fail(f"{what}: launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] += v
        return out, launches, time.perf_counter() - t

    for argv, epochs in ((["--epochs", "2"], 2),
                         (["--epochs", "3", "--restore_file", "last"], 1)):
        out = io.StringIO()

        def run():
            with contextlib.redirect_stdout(out):
                return train_cli.main(base + argv)

        rc, launches, sec = counted(f"ParticleNet train CLI {argv}", run,
                                    epochs * (steps + evals), epochs * steps)
        text = out.getvalue()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("particlenet:", "feed:", "Training epoch",
                                   "- Eval", "Restarting"))]
        say("pn_train", argv=argv, seconds=sec, launches=launches,
            epoch_seconds=epoch_seconds(text), log=lines)
        if rc != 0:
            fail(f"ParticleNet train CLI {argv} exited {rc}")
        check_feed_line("ParticleNet train CLI", text)
    for f in ("loss.log", "metrics_val_best.json", "best.ckpt", "last.ckpt",
              "config.json"):
        if not os.path.exists(os.path.join(ck, f)):
            fail(f"ParticleNet train CLI wrote no {f}")
    rows = [ln.split(",") for ln in open(os.path.join(ck, "loss.log"))
            if ln[:1].isdigit()]
    if [r[0] for r in rows] != ["1", "2", "3"] or not all(
            np.isfinite(float(v)) for r in rows for v in r[1:]):
        fail(f"ParticleNet loss.log rows are not epochs 1-3 with finite "
             f"losses: {rows}")
    if not float(rows[1][1]) < float(rows[0][1]):
        fail(f"ParticleNet train loss did not fall from epoch 1 to 2: {rows}")
    with open(os.path.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    ev = os.path.join(work, "pn_train_eval")
    os.makedirs(ev)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(ck, f), ev)
    got, launches, sec = counted(
        "ParticleNet evaluate CLI", lambda: evaluate_cli.run(
            ["--model", "particlenet", "--synthetic", str(PN_TRAIN_EVENTS),
             "--ckpts", ev, "--batch_size", str(PN_TRAIN_B)])["loss"],
        evals, 0)
    rel = abs(got - best) / abs(best)
    say("pn_train_reeval", metrics_val_best=best, evaluate_cli=got,
        rel_err=rel, launches=launches, seconds=sec,
        loss_log=[",".join(r).strip() for r in rows])
    if not rel <= REEVAL_RTOL:
        fail(f"evaluate CLI gives {got} on the ParticleNet train CLI's "
             f"best.ckpt, not within {REEVAL_RTOL} of its "
             f"metrics_val_best.json {best}")
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
    embed_counts(zero=True)
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
    check_embed_counts("neighbor_list evaluate", 10, 0)
    return loss


def nl_predict_phase(work: str) -> None:
    """The predict CLI in neighbor_list mode over synthetic 2000."""
    import numpy as np
    from deepmetv2_tpu_torch.cli import predict as predict_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import window_max

    out = os.path.join(work, "pred_nl.npz")
    window_max.launches = 0
    embed_counts(zero=True)
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
    check_embed_counts("neighbor_list predict", 50, 0)


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
    embed_counts(zero=True)

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
    check_embed_counts("neighbor_list train resume", len(hosts), len(hosts))


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
    embed_counts(zero=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, sec, peak = peak_run(lambda: train_cli.main(
            ["--synthetic", "2000", "--batch_size", str(TRAIN_B), "--ckpts",
             ck, "--epochs", "1", "--graph_mode", "neighbor_list"]))
    embed = embed_counts()
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
    check_embed_counts("neighbor_list train CLI", 250, 200, embed)
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


BF16_KERNELS = ("window_max_bf16", "window_max_bwd_bf16")


def window_counts(zero: bool = False) -> dict:
    """The four window kernels' launch counts (f32 and bf16 forward and
    backward), set to 0 first with ``zero``."""
    from deepmetv2_tpu_torch.ops.cuda import edgeconv_window as ew

    fns = [ew.window_max, ew.window_max_bwd, ew.window_max_bf16,
           ew.window_max_bwd_bf16]
    if zero:
        for fn in fns:
            fn.launches = 0
    return {fn.__name__: fn.launches for fn in fns}


def check_window_counts(what: str, want: dict) -> None:
    """Fail unless the window kernels' counts are ``want`` (others 0)."""
    got = window_counts()
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        fail(f"{what}: window kernel launches {got}, want {want}")


# the cat_embed op's launches summed over the main-path runs that
# check_embed_counts checked: the kernels line reports these
EMBED_MAIN = {"cat_embed_fwd": 0, "cat_embed_bwd": 0}


def embed_counts(zero: bool = False) -> dict:
    """The cat_embed op's launch counts (forward, backward), set to 0
    first with ``zero``."""
    from deepmetv2_tpu_torch.ops.cuda import cat_embed as ce

    fns = [ce.cat_embed_fwd, ce.cat_embed_bwd]
    if zero:
        for fn in fns:
            fn.launches = 0
    return {fn.__name__: fn.launches for fn in fns}


def check_embed_counts(what: str, fwd: int, bwd: int, got=None) -> dict:
    """Fail unless ``what`` launched the cat_embed op's forward ``fwd``
    times (one a batch) and its backward ``bwd`` times (one a train step):
    ``got``, a rank's counts, or else this process's since the last zero.
    Adds them to EMBED_MAIN."""
    got = embed_counts() if got is None else got
    want = {"cat_embed_fwd": fwd, "cat_embed_bwd": bwd}
    if got != want:
        fail(f"{what}: cat_embed launches {got}, want {want}")
    for k, n in got.items():
        EMBED_MAIN[k] += n
    return got


def kernel_bf16_phase(device):
    """The bf16 instantiations of both window kernels against their plain
    versions on bf16 tensors, bitwise on every row (padded rows -inf / 0):
    (e) the evaluation shape, (t) the training shape (cell order, halo
    192), (h8 ... h128) H in {8, 33, 64, 128} on the training batch, (p)
    the evaluation batch with two blocks of 32 padded rows inside an event
    and an all-padded event, (l) lattice values (ties, ±0.0) on the
    training batch; with the times and bounds at both shapes.  Returns the
    forward's and the backward's kernel-line numbers."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
        window_max, window_max_bwd)
    from deepmetv2_tpu_torch.ops.window import (PAD_POS, padded_rows,
                                                window_max_bwd_torch,
                                                window_max_torch)
    from deepmetv2_tpu_torch.probes.window_breakdown import probe_inputs

    rng = np.random.default_rng(2)
    r2 = R ** 2
    inputs = probe_inputs(device)
    c_e, pos_e, halo_e = inputs["eval"]
    c_t, pos_t, _ = inputs["train"]

    def bf16(shape, lattice=False):
        v = rng.normal(size=shape)
        if lattice:
            v = np.round(v * 4) / 4 * np.where(rng.random(shape) < 0.5, 1, -1)
        return torch.as_tensor(v.astype(np.float32),
                               device=device).to(torch.bfloat16)

    pos_p = pos_e.clone()
    pos_p[0, 64:128] = PAD_POS
    pos_p[1] = PAD_POS
    cases = {"e": (c_e.to(torch.bfloat16), pos_e, halo_e),
             "t": (c_t.to(torch.bfloat16), pos_t, TRAIN_HALO),
             "p": (c_e.to(torch.bfloat16), pos_p, halo_e),
             "l": (bf16(tuple(c_t.shape), True), pos_t, TRAIN_HALO)}
    for H in (8, 33, 64, 128):
        cases[f"h{H}"] = (bf16((TRAIN_B, TRAIN_N, H)), pos_t, TRAIN_HALO)
    window_counts(zero=True)
    ties = {}
    for name, (c, pos, halo) in cases.items():
        real = ~padded_rows(pos)
        m = window_max(c, pos, r2, halo)
        mt = window_max_torch(c, pos, real, r2, halo)
        g = bf16(tuple(c.shape), name == "l")
        dc = window_max_bwd(c, pos, m, g, r2, halo)
        dt = window_max_bwd_torch(c, pos, m, g, r2, halo)
        torch.cuda.synchronize()
        if m.dtype != torch.bfloat16 or dc.dtype != torch.bfloat16:
            fail(f"bf16 case {name}: outputs {m.dtype}, {dc.dtype}")
        if not bitwise_equal(m, mt):
            fail(f"window_max_fwd_bf16 case {name}: {n_differ(m, mt)} "
                 "entries differ from the plain version")
        if not bitwise_equal(dc, dt):
            fail(f"window_max_bwd_bf16 case {name}: {n_differ(dc, dt)} "
                 "entries differ from the plain version")
        if bool((m[~real].float() != float("-inf")).any()) or bool(
                (dc[~real].float() != 0).any()):
            fail(f"bf16 case {name}: a padded row is not -inf / 0")
        ones = window_max_bwd(c, pos, m, torch.ones_like(m), r2, halo)
        ties[name] = int(ones.double().sum().item()
                         - torch.isfinite(m.float()).sum().item())
    launches = window_counts()
    if launches != {"window_max": 0, "window_max_bwd": 0,
                    "window_max_bf16": len(cases),
                    "window_max_bwd_bf16": 2 * len(cases)}:
        fail(f"bf16 cases launched {launches}")
    if ties["l"] <= 0:
        fail("bf16 case l has no tied maxima: the tie rule was not exercised")

    c, pos, halo = cases["e"]
    real = ~padded_rows(pos)
    H = c.shape[-1]
    fwd_ms = cuda_ms(lambda: window_max(c, pos, r2, halo), 50)
    fwd_plain = cuda_ms(lambda: window_max_torch(c, pos, real, r2, halo), 5)
    pairs, adj = window_work(pos, real, halo, r2)
    fwd_bound = bound(window_bytes_bf16(pos, H, 1), 6 * pairs + H * adj)

    c, pos, halo = cases["t"]
    real = ~padded_rows(pos)
    m = window_max(c, pos, r2, halo)
    g = bf16(tuple(c.shape)) * real[..., None]
    t_fwd_ms = cuda_ms(lambda: window_max(c, pos, r2, halo), 50)
    bwd_ms = cuda_ms(lambda: window_max_bwd(c, pos, m, g, r2, halo), 50)
    bwd_plain = cuda_ms(lambda: window_max_bwd_torch(c, pos, m, g, r2, halo),
                        3)
    t_pairs, t_adj = window_work(pos, real, halo, r2)
    t_fwd_bound = bound(window_bytes_bf16(pos, H, 1), 6 * t_pairs + H * t_adj)
    bwd_bound = bound(window_bytes_bf16(pos, H, 3),
                      6 * t_pairs + 2 * H * t_adj)
    # each kernel's own device time per launch (torch.profiler), f32 and
    # bf16 on the same inputs: the wrappers' ms above include the host
    m32, g32 = window_max(c_t, pos, r2, halo), g.float()
    calls = {"fwd_eval": (lambda: window_max(c_e, pos_e, r2, halo_e),
                          lambda: window_max(cases["e"][0], pos_e, r2,
                                             halo_e)),
             "fwd_train": (lambda: window_max(c_t, pos, r2, halo),
                           lambda: window_max(c, pos, r2, halo)),
             "bwd_train": (lambda: window_max_bwd(c_t, pos, m32, g32, r2,
                                                  halo),
                           lambda: window_max_bwd(c, pos, m, g, r2, halo))}
    kernel_ms = {k: {"float32": step_profile(f32, 20, cpu=False)[0],
                     "bfloat16": step_profile(bf, 20, cpu=False)[0]}
                 for k, (f32, bf) in calls.items()}
    say("kernel_bf16", cases=",".join(cases) + " bitwise equal",
        extra_tied_sources=ties, eval_shape=list(cases["e"][0].shape),
        eval_halo=halo_e, fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain,
        fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
        train_shape=list(c.shape), train_halo=TRAIN_HALO,
        train_fwd_ms=t_fwd_ms, train_fwd_bound_ms=t_fwd_bound[0],
        bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain, bwd_bound_ms=bwd_bound[0],
        bwd_bound_by=bwd_bound[1], kernel_ms=kernel_ms, card=CARD)
    return ({"max_abs_err": 0.0, "ms": fwd_ms, "plain_ms": fwd_plain,
             "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
            {"max_abs_err": 0.0, "ms": bwd_ms, "plain_ms": bwd_plain,
             "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]})


def bf16_evaluate_phase(work: str) -> int:
    """The evaluate CLI on synthetic 2000 from a copy of ckpts_syn_bf16
    (compute_dtype bfloat16): the loss within BF16_LOSS_RTOL of
    GOLDEN_BF16_LOSS, 20 launches of the bf16 forward and no f32 window
    launch; the distance to the TPU's recorded loss printed.  Returns the
    bf16 forward's launches."""
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli

    ck = ckpt_copy(work, "bf16", "ckpts_syn_bf16")
    window_counts(zero=True)
    embed_counts(zero=True)
    metrics, sec, peak = peak_run(lambda: evaluate_cli.run(
        ["--synthetic", "2000", "--ckpts", ck, "--restore_file", "best"]))
    loss = metrics["loss"]
    rel = abs(loss - GOLDEN_BF16_LOSS) / GOLDEN_BF16_LOSS
    say("bf16_evaluate", loss=loss, golden=GOLDEN_BF16_LOSS, rel_err=rel,
        gate=BF16_LOSS_RTOL, jax_tpu_recorded=JAX_TPU_BF16_LOSS,
        rel_to_tpu_recorded=abs(loss - JAX_TPU_BF16_LOSS) / JAX_TPU_BF16_LOSS,
        launches=window_counts(), seconds=sec, peak_mb=peak)
    if not rel <= BF16_LOSS_RTOL:
        fail(f"bf16 validation loss {loss} is not within {BF16_LOSS_RTOL} "
             f"of {GOLDEN_BF16_LOSS}")
    check_window_counts("bf16 evaluate", {"window_max_bf16": 2 * 10})
    check_embed_counts("bf16 evaluate", 10, 0)
    return 2 * 10


def bf16_train_resume_phase(device) -> None:
    """10 train steps from ckpts_syn_bf16/best.ckpt in bf16 through the
    chained runner as chains of 8 and 2, each loss within BF16_TRAIN_RTOL
    of GOLDEN_BF16_TRAIN_LOSSES; 20 launches of each bf16 kernel, none of
    the f32 ones."""
    import dataclasses
    import itertools

    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.chain import (make_chained_train_step,
                                                 stack_batches)
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.step import make_optimizer

    ck = os.path.join(HERE, "ckpts_syn_bf16")
    cfg = load_run_config(ck)
    cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, mode="window", window_halo=TRAIN_HALO, presorted=True))
    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(cfg, model)
    payload = restore_checkpoint(os.path.join(ck, "best.ckpt"), model, opt)
    ld = fetch_dataloader(events=synthetic_events(2000, seed=42),
                          batch_size=TRAIN_B, presort_eta=True,
                          presort_mode="cell")["train"]
    hosts = list(itertools.islice(iter(ld), len(GOLDEN_BF16_TRAIN_LOSSES)))
    runner = make_chained_train_step(cfg)
    window_counts(zero=True)
    embed_counts(zero=True)

    def run():
        return [v for chain in (hosts[:8], hosts[8:]) for v in runner(
            model, opt, to_device(stack_batches(chain), device)).tolist()]

    losses, sec, peak = peak_run(run)
    rel = [abs(a - b) / abs(b)
           for a, b in zip(losses, GOLDEN_BF16_TRAIN_LOSSES)]
    say("bf16_train_resume", compute_dtype=cfg.model.compute_dtype,
        epoch=payload["epoch"], chains=[8, 2], losses=losses,
        golden=GOLDEN_BF16_TRAIN_LOSSES, max_rel_err=max(rel),
        gate=BF16_TRAIN_RTOL, launches=window_counts(), seconds=sec,
        peak_mb=peak)
    if cfg.model.compute_dtype != "bfloat16" or not max(rel) <= \
            BF16_TRAIN_RTOL:
        fail(f"bf16 resumed train losses are not within {BF16_TRAIN_RTOL} "
             f"of the JAX package's: {losses}")
    check_window_counts("bf16 train resume", {"window_max_bf16": 20,
                                              "window_max_bwd_bf16": 20})
    check_embed_counts("bf16 train resume", len(hosts), len(hosts))


def bf16_train_phase(work: str):
    """The train CLI with --compute_dtype bfloat16 for 1 epoch on synthetic
    2000, chained and resident by the config (its "feed:" line: the steps
    replayed as CUDA graphs), the exact bf16 launch counts with replays and
    no f32 window launch, the dtype in its config.json, and its best.ckpt
    re-evaluated by the evaluate CLI within REEVAL_RTOL.  Returns (forward,
    backward) launches."""
    import torch
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import train as train_cli

    ck = os.path.join(work, "bf16_train")
    window_counts(zero=True)
    embed_counts(zero=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, sec, peak = peak_run(lambda: train_cli.main(
            ["--synthetic", "2000", "--batch_size", str(TRAIN_B), "--ckpts",
             ck, "--epochs", "1", "--compute_dtype", "bfloat16"]))
    launches, embed = window_counts(), embed_counts()
    text = out.getvalue()
    with open(os.path.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    with open(os.path.join(ck, "config.json")) as f:
        dtype = json.load(f)["model"]["compute_dtype"]
    ev = ckpt_copy(work, "bf16_train_eval", ck)
    got = evaluate_cli.run(["--synthetic", "2000", "--ckpts", ev,
                            "--batch_size", str(TRAIN_B)])["loss"]
    torch.cuda.synchronize()
    rel = abs(got - best) / abs(best)
    say("bf16_train", seconds=sec, peak_mb=peak,
        epoch_seconds=epoch_seconds(text), compute_dtype=dtype,
        launches=launches, metrics_val_best=best, evaluate_cli=got,
        rel_err=rel, log=[ln for ln in text.splitlines() if ln.startswith(
            ("graph mode", "feed:", "Training epoch", "- Eval"))])
    if rc != 0:
        fail(f"bf16 train CLI exited {rc}")
    check_feed_line("bf16 train CLI", text)
    if dtype != "bfloat16":
        fail(f"bf16 train CLI recorded compute_dtype {dtype!r}")
    steps, evals, convs = 200, 50, 2
    want = {"window_max_bf16": (steps + evals) * convs,
            "window_max_bwd_bf16": steps * convs}
    if launches != dict({"window_max": 0, "window_max_bwd": 0}, **want):
        fail(f"bf16 train CLI: window launches {launches}, want {want}")
    check_embed_counts("bf16 train CLI", steps + evals, steps, embed)
    if not rel <= REEVAL_RTOL:
        fail(f"evaluate CLI gives {got} on the bf16 train CLI's best.ckpt, "
             f"not within {REEVAL_RTOL} of {best}")
    return want["window_max_bf16"], want["window_max_bwd_bf16"]


# --------------------------------------------------------------- the mesh
# The mesh phases run the port's parallel/ package on this one card: two
# ranks that share it through gloo (collectives staged through host copies,
# parallel/mesh.py) for --mesh 2 and --mesh 1x2, and one rank on NCCL for
# --mesh 1.  Their times measure the staging, not the design.

MESH_EVAL_B = 40        # the evaluate CLI's batch
MESH_CLI_EVENTS = 400   # the --mesh 1x2 CLI run's synthetic events


@functools.lru_cache(maxsize=None)
def resume_hosts():
    """The first 10 cell-sorted train batches of synthetic 2000 (batch 8),
    those of train_resume_phase."""
    import itertools

    from deepmetv2_tpu_torch.data import fetch_dataloader

    ld = fetch_dataloader(events=smoke_events(), batch_size=TRAIN_B,
                          presort_eta=True, presort_mode="cell")["train"]
    return list(itertools.islice(iter(ld), len(GOLDEN_TRAIN_LOSSES)))


def mesh_resume_setup(device):
    """(model, optimizer, config, the first 10 cell-sorted train batches):
    ckpts_syn/best.ckpt resumed as train_resume_phase resumes it."""
    import dataclasses

    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
    from deepmetv2_tpu_torch.train.step import make_optimizer

    ck = os.path.join(HERE, "ckpts_syn")
    cfg = load_run_config(ck)
    cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, mode="window", window_halo=TRAIN_HALO, presorted=True))
    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(cfg, model)
    restore_checkpoint(os.path.join(ck, "best.ckpt"), model, opt,
                       ReduceLROnPlateau(lr=cfg.optim.lr))
    return model, opt, cfg, resume_hosts()


def ep_launches_per_conv(n_nodes: int, n_node: int, halo: int) -> int:
    """Window-kernel launches of one sharded EdgeConv (forward or
    backward): two in the overlap schedule (local shard, boundary strips),
    one in the serial one (parallel/halo.py)."""
    from deepmetv2_tpu_torch.parallel.halo import halo_pad

    return 2 if n_nodes // n_node >= 2 * halo_pad(halo) else 1


def mesh_train_rank(device, dims):
    """One rank's 10 resumed steps on a (data, node) mesh through the mesh
    chain runner (chains of 8 and 2), each rank staging its own rows; its
    losses, window launches (counted from 0) and the launches the schedule
    predicts."""
    import torch
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.parallel.mesh import Mesh, shard_batch
    from deepmetv2_tpu_torch.train.chain import (make_chained_train_step,
                                                 stack_batches)

    mesh = Mesh(*dims, device=device)
    shard = dims[1] > 1
    model, opt, cfg, hosts = mesh_resume_setup(device)
    runner = make_chained_train_step(cfg, "graphmet", mesh, shard)
    per = [ep_launches_per_conv(h.x_cont.shape[1], dims[1], TRAIN_HALO)
           if shard else 1 for h in hosts]
    want = 2 * sum(per)                       # 2 EdgeConvs a step
    losses = []
    window_counts(zero=True)
    embed_counts(zero=True)
    t = time.perf_counter()
    for chain in (hosts[:8], hosts[8:]):
        if not chain:
            continue
        local = shard_batch(stack_batches(chain), mesh, shard, chained=True)
        losses += runner(model, opt, to_device(local, device)).tolist()
    torch.cuda.synchronize()
    return dict(losses=losses, launches=window_counts(), want=want,
                embed=embed_counts(), steps=len(hosts),
                seconds=time.perf_counter() - t, mesh=mesh.describe())


def mesh_window_rank(device):
    """The sharded window max on the 1x2 mesh against the single-device
    kernel on one full-width batch (the first train batch's positions,
    cell order, halo TRAIN_HALO, random c at H=32): the forward bitwise on
    real rows (−inf on padded ones), the gradient of Σ m² within
    GRAD_ATOL of its largest entry.  Rank 0 compares and reports."""
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)
    from deepmetv2_tpu_torch.ops.window import padded_pos, padded_rows
    from deepmetv2_tpu_torch.parallel.halo import (halo_pad,
                                                   window_max_sharded)
    from deepmetv2_tpu_torch.parallel.mesh import Mesh
    from deepmetv2_tpu_torch.train.step import _etaphi
    from deepmetv2_tpu_torch.data import to_device

    mesh = Mesh(1, 2, device=device)
    _, _, _, hosts = mesh_resume_setup(device)
    batch = to_device(hosts[0], device)
    pos = padded_pos(_etaphi(batch), batch.mask).contiguous()
    gen = torch.Generator().manual_seed(11)
    c = torch.randn(batch.x_cont.shape[:2] + (32,), generator=gen).to(device)
    n_loc = c.shape[1] // 2
    rows = slice(mesh.node_index * n_loc, (mesh.node_index + 1) * n_loc)
    c_loc = c[:, rows].clone().requires_grad_(True)
    r2 = R * R
    m_loc = window_max_sharded(c_loc, pos[:, rows].contiguous(), r2,
                               TRAIN_HALO, mesh)
    torch.where(torch.isfinite(m_loc), m_loc, torch.zeros_like(m_loc)).pow(
        2).sum().backward()
    m = torch.cat(mesh.all_gather(m_loc.detach(), mesh.node_group), 1)
    dc = torch.cat(mesh.all_gather(c_loc.grad, mesh.node_group), 1)
    if mesh.rank != 0:
        return {}
    h = halo_pad(TRAIN_HALO)
    want = window_max(c, pos, r2, h)
    g = torch.where(torch.isfinite(want), 2 * want, torch.zeros_like(want))
    want_dc = window_max_bwd(c, pos, want, g, r2, h)
    real = ~padded_rows(pos)
    top = float(want_dc.abs().max())
    return dict(shape=list(c.shape), halo=TRAIN_HALO, halo_pad=h,
                fwd_bitwise=bitwise_equal(m[real], want[real]),
                padded_neg_inf=bool(torch.isneginf(m[~real]).all()),
                max_abs_dc=top, max_dc_diff=float((dc - want_dc).abs().max()))


def mesh_eval_rank(device):
    """GraphMET's validation pass of the evaluate CLI (ckpts_syn,
    synthetic 2000, batch 40, eta sort on the device, the halo sized on the
    whole dataset) through the data-parallel evaluation step on 2 ranks:
    the loss and the rank's window launches."""
    import argparse

    import torch
    from deepmetv2_tpu_torch.cli.common import (apply_graph_mode,
                                                load_run_config)
    from deepmetv2_tpu_torch.data import fetch_dataloader
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.parallel.dp import (eval_padding,
                                                 make_sharded_eval)
    from deepmetv2_tpu_torch.parallel.mesh import Mesh
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint
    from deepmetv2_tpu_torch.train.loop import evaluate

    mesh = Mesh(2, 1, device=device)
    ck = os.path.join(HERE, "ckpts_syn")
    cfg = load_run_config(ck)
    ld = fetch_dataloader(events=smoke_events(),
                          batch_size=MESH_EVAL_B, validation_split=0.2,
                          buckets=cfg.data.node_buckets)["test"]
    cfg = apply_graph_mode(cfg, argparse.Namespace(graph_mode="window"),
                           ld.dataset)
    payload = load_checkpoint(os.path.join(ck, "best.ckpt"))
    model = GraphMET(cfg.model, device=device).params_from_jax(
        payload["params"], payload["bn_state"])
    step, _ = make_sharded_eval(cfg, mesh)
    window_counts(zero=True)
    embed_counts(zero=True)
    t = time.perf_counter()
    metrics, _ = evaluate(model, step, ld, cfg, device, verbose=False,
                          pad=eval_padding(mesh))
    torch.cuda.synchronize()
    return dict(loss=metrics["loss"], launches=window_counts(),
                want=2 * len(ld), batches=len(ld), embed=embed_counts(),
                seconds=time.perf_counter() - t)


def mesh_drn_eval_rank(device):
    """The DRN's validation pass (ckpts_syn_drn, 400 events at batch 8)
    through the data-parallel evaluation step on 2 ranks (the composed
    build and the gather-reduce conv): each batch's loss and MET vectors,
    and, for drn_golden_rule, this rank's events' graph digests from a
    second pass of the same forward with its decisions recorded (its MET
    must equal the step's bit for bit)."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.models.drn import drn_net_apply
    from deepmetv2_tpu_torch.parallel import context as pctx
    from deepmetv2_tpu_torch.parallel.dp import (DRN_MESH_FORCES,
                                                 make_sharded_eval)
    from deepmetv2_tpu_torch.parallel.mesh import Mesh, shard_batch
    from deepmetv2_tpu_torch.train.loss import drn_met_vector

    mesh = Mesh(2, 1, device=device)
    model, cfg = drn_model(device)
    ld = drn_val_loader(cfg, 8)
    step, place = make_sharded_eval(cfg, mesh, "drn")
    counters = drn_counters()
    for fn in counters.values():
        fn.launches = 0
    losses, mets, digests, same = [], [], [], True
    t = time.perf_counter()
    for host in ld:
        placed = place(host)
        v, loss, _ = step(model, placed)
        losses.append(float(loss))
        mets.append(v.cpu().numpy())
        local = shard_batch(placed, mesh)
        diag = {}
        with torch.no_grad(), pctx.data_parallel(mesh):
            pred = drn_net_apply(model.eval(), local, diag, **DRN_MESH_FORCES)
        rows = v[mesh.data_index * local.batch_size:
                 (mesh.data_index + 1) * local.batch_size]
        same = same and bitwise_equal(drn_met_vector(pred, cfg.drn.head),
                                      rows)
        digests.append(drn_graph_digests(
            [[t.cpu().numpy() for t in (m, nbr.idx, nbr.mask, c, p)]
             for m, nbr, c, p in diag["rounds"]]))
    torch.cuda.synchronize()
    return dict(losses=losses, met=np.stack(mets), digests=np.stack(digests),
                same_met=same, seconds=time.perf_counter() - t,
                launches={k: fn.launches for k, fn in counters.items()})


# The node-sharded DRN (parallel/dyn.py) on the same two ranks, at the
# DRN's full width (ckpts_syn_drn: H=64, k=16, cap 32, two rounds, the 2048
# bucket), layout 1x2.  The distributed kNN builds and the single-device
# knn_graph round d² differently (f32 rounds |q|² + |s|² − 2q·s to a few
# 1e-7 of |q|² + |s|², at most about 4e-6 at H=64), so a row whose k-th and
# (k+1)-th candidates' squared distances (in f64) lie within DRN_EP_TIE of
# |q|² + |s|² (the larger |s|² of the two) keeps either neighbour: such rows
# are counted and left out of the set comparison.  The two builds round
# every pair alike, so they are held to each other bitwise on every row
# without an exact tie of their own d² among its first k+1 candidates (on
# one the ring keeps the neighbour it visited first, ROADMAP "Known
# divergences"); those rows are counted.
DRN_EP_TIE = 1e-5
DRN_EP_STEP0_RTOL = 1e-5   # step 0 against the composed step, same graphs
# every step against the single-device step on the same graphs: the loss
# relatively, each tensor relative to its largest |value| (drn_replay_steps)
DRN_EP_REPLAY_RTOL = 1e-5
DRN_EP_RING_BATCHES = 5    # validation batches run again with the ring
DRN_EP_CLI_EVENTS = 40     # the --mesh 1x2 --ring_knn CLI run's events


def compacted_rounds(rounds):
    """Per-round decisions ``(mask, idx, slot mask, cluster, partner)``
    (numpy) with each node renumbered by its rank among the round's real
    rows: the labelling of a path that compacts between rounds
    (models/drn.py:_compact_nodes keeps their order), so the node-sharded
    path, which does not, gives the composed path's digests."""
    import numpy as np

    out = []
    for mask, idx, nmask, cluster, partner in rounds:
        rank = np.cumsum(mask, axis=1) - 1

        def lab(a):
            flat = a.reshape(a.shape[0], -1).astype(np.int64)
            return np.take_along_axis(rank, flat, 1).reshape(a.shape)

        out.append((mask, np.where(nmask, lab(idx), 0), nmask, lab(cluster),
                    lab(partner)))
    return out


def knn_tie_rows(h, mask, k: int, n_node: int):
    """``(near, exact)`` [B, N] bool on the real rows of ``h``: the k-th
    and (k+1)-th valid candidates (self excluded) within DRN_EP_TIE of
    each other (squared distances in f64, the tolerance relative to |q|² +
    |s|²); two of the first k+1 candidates at an equal d² of the
    distributed builds (their own arithmetic over ``n_node`` shards,
    parallel/knn.py:_block_d2)."""
    import torch
    from deepmetv2_tpu_torch.parallel.knn import _block_d2

    hd = h.double()
    sq = (hd * hd).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * hd @ hd.transpose(1, 2)
    n = h.shape[1]
    ok = (mask[:, :, None] & mask[:, None, :]
          & ~torch.eye(n, dtype=torch.bool, device=h.device)[None])
    vals, order = torch.sort(d2.masked_fill(~ok, float("inf")), dim=-1)
    vals, order = vals[..., :k + 1], order[..., :k + 1]
    s_sq = torch.gather(sq[:, None, :].expand(-1, n, -1), 2, order)
    scale = sq + torch.maximum(s_sq[..., k], s_sq[..., k - 1])
    near = vals[..., k] - vals[..., k - 1] <= DRN_EP_TIE * scale  # nan: no
    n_loc, exact = n // n_node, []
    for q0 in range(0, n, n_loc):
        q, qm = h[:, q0:q0 + n_loc].contiguous(), mask[:, q0:q0 + n_loc]
        own = torch.cat([_block_d2(q, (q * q).sum(-1), qm, q0,
                                   h[:, s0:s0 + n_loc].contiguous(),
                                   mask[:, s0:s0 + n_loc], s0, False)
                         for s0 in range(0, n, n_loc)], dim=-1)
        v = torch.sort(own, dim=-1).values[..., :k + 1]
        exact.append(((v[..., 1:] == v[..., :-1])
                      & torch.isfinite(v[..., 1:])).any(-1))
    return near & mask, torch.cat(exact, dim=1) & mask


def drn_noise_path(path) -> bool:
    """A DRN tensor whose exact gradient is about 0 because a masked
    BatchNorm follows it: each round's last edge-MLP bias, and the
    BatchNorm running mean that tracks it.  AdamW turns their f32 rounding
    noise, summed in another order on a mesh, into steps of up to lr of
    either sign (tests/test_torch_mesh.py:noise_path)."""
    return path[1] == "convs" and (path[3:] == (0,)
                                   or path[3:] == ("mlp", "lin1", "b"))


def drn_replay_steps(resumed, tcfg, hosts, replay, losses, states, device):
    """The node-sharded train steps' single-device reference on their own
    graphs: the resumed model stepped by the single-device train step on
    each whole batch, each round's kNN lists and matching replayed from
    the sharded step's (``replay``: per step, the gathered lists and
    ``(cluster, partner)`` of each round), the conv the same fused
    kernels.  Per step: the loss's relative error, and the worst tensor's
    error over its allowance (DRN_EP_REPLAY_RTOL of the tensor's largest
    |value|, at least 1; drn_noise_path tensors 2·lr per step), against
    the sharded step's loss and model (``states``)."""
    from unittest import mock

    import torch
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.models import drn as tdrn
    from deepmetv2_tpu_torch.train.loss import drn_loss_fn
    from deepmetv2_tpu_torch.train.step import make_train_step

    model, opt = resumed()
    lr = float(opt.param_groups[0]["lr"])
    rel, worst = [], []
    for i, (host, (lists, matches)) in enumerate(zip(hosts, replay)):
        knn, pairs = iter(lists), iter(matches)
        step = make_train_step(tcfg, lambda m, b: drn_loss_fn(
            tdrn.drn_net_apply(m, b, knn_fn=lambda h, mask: next(knn)), b,
            tcfg.drn.head))
        with mock.patch.object(tdrn, "handshake_matching",
                               lambda *a, **kw: next(pairs)):
            loss = float(step(model, opt, to_device(host, device)))
        rel.append(abs(loss - losses[i]) / abs(loss))
        errs = []
        for path, ref in model.jax_layout():
            ref = ref.detach().double()
            got = states[i][path].double()
            allow = (2 * lr * (i + 1) if drn_noise_path(path) else
                     DRN_EP_REPLAY_RTOL * max(float(ref.abs().max()), 1.0))
            errs.append((float((got - ref).abs().max()) / allow,
                         "/".join(map(str, path))))
        worst.append(max(errs))
    return dict(loss_rel_err=rel, worst_over_allowance=[w[0] for w in worst],
                worst_tensor=[w[1] for w in worst], lr=lr)


def mesh_drn_ep_rank(device):
    """The node-sharded DRN on the 1x2 mesh, one rank's part:
    (a) both kNN builds on the round-1 features of the first full-width
    validation batch (B=8, N=2048, H=64), gathered, and on rank 0 against
    the single-device knn_graph; (b) the sharded forward in eval mode over
    the 400 validation events at batch 8 (MET, losses, per-round graph
    digests in the compacted labelling), then the first
    DRN_EP_RING_BATCHES batches with the ring build; (c) 10 train steps
    resumed from ckpts_syn_drn/best.ckpt at batch 16 through the mesh
    train step (with their graph digests, their host step times and the
    last step under utils/profiling.trace), and on rank 0 the port's
    single-device steps on the same batches, on the composed graph build
    with the conv the sharded path takes (the fused conv), and on the
    sharded steps' own graphs (drn_replay_steps); (d) the DRN kernels'
    launches over (b) and (c)."""
    import itertools
    from unittest import mock

    import numpy as np
    import torch
    from deepmetv2_tpu_torch.data import fetch_dataloader, to_device
    from deepmetv2_tpu_torch.models import drn as tdrn
    from deepmetv2_tpu_torch.data.batching import Neighborhood
    from deepmetv2_tpu_torch.ops.graph import knn_graph
    from deepmetv2_tpu_torch.parallel import dyn as tdyn
    from deepmetv2_tpu_torch.parallel.dyn import (NodeShards,
                                                  drn_net_apply_sharded)
    from deepmetv2_tpu_torch.parallel.knn import (knn_graph_sharded,
                                                  knn_graph_sharded_ring)
    from deepmetv2_tpu_torch.parallel.mesh import Mesh, shard_batch
    from deepmetv2_tpu_torch.train.chain import mesh_train_step
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.loss import drn_loss_fn, drn_met_vector
    from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
    from deepmetv2_tpu_torch.train.step import (make_optimizer,
                                                make_train_step)
    from deepmetv2_tpu_torch.utils import profiling

    mesh = Mesh(1, 2, device=device)
    counters = drn_train_counters()
    model, cfg = drn_model(device)
    head, k = cfg.drn.head, cfg.drn.k
    ld = drn_val_loader(cfg, 8)
    out = {}

    # (a) the kNN builds
    batch = to_device(next(b for b in ld if b.x_cont.shape[1] == DRN_N),
                      device)
    h = drn_features(model, batch)
    nodes = NodeShards(mesh)
    h_loc, m_loc = nodes.local(h).contiguous(), nodes.local(batch.mask)
    built, secs = {}, {}
    for name, build in (("all_gather", knn_graph_sharded),
                        ("ring", knn_graph_sharded_ring)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nb = build(h_loc, m_loc.contiguous(), k=k, mesh=mesh)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        built[name] = [torch.cat(mesh.all_gather(a, mesh.node_group), 1)
                       for a in nb]
    knn = dict(seconds=secs)
    if mesh.rank == 0:
        ref = knn_graph(h, batch.mask, k=k)
        near, exact = knn_tie_rows(h, batch.mask, k, mesh.n_node)
        big = torch.iinfo(torch.int32).max

        def sets(idx, m):
            return torch.sort(torch.where(m, idx, big), dim=-1).values

        ag, ring = built["all_gather"], built["ring"]
        clean, clear = batch.mask & ~near, batch.mask & ~exact
        knn.update(
            shape=list(h.shape), k=k, real_rows=int(batch.mask.sum()),
            near_tie_rows_at_k=int(near.sum()),
            exact_tie_rows=int(exact.sum()),
            masks_equal={n: bool(torch.equal(b[1], ref.mask))
                         for n, b in built.items()},
            set_rows_differ={n: int((sets(*b) != sets(*ref)).any(-1)[
                clean].sum()) for n, b in built.items()},
            ring_rows_differ=int(((ag[0] != ring[0]) | (ag[1] != ring[1]))
                                 .any(-1)[clear].sum()),
            ring_rows_differ_on_ties=int(((ag[0] != ring[0])
                                          | (ag[1] != ring[1])).any(-1)[
                exact].sum()))
    out["knn"] = knn
    del h, h_loc, built, batch

    # (b) the sharded forward over the validation events
    def sharded_pass(pairs, ring):
        losses, mets, graphs = [], [], []
        for host, ids in pairs:
            b = shard_batch(to_device(host, device), mesh, True)
            diag = {}
            with torch.no_grad():
                pred = drn_net_apply_sharded(model.eval(), b, mesh, ring,
                                             diag)
            losses.append(float(drn_loss_fn(pred, b, head)))
            mets.append(drn_met_vector(pred, head)[:len(ids)].cpu().numpy())
            graphs.append(drn_graph_digests(compacted_rounds(
                [[t.cpu().numpy() for t in (m, nbr.idx, nbr.mask, c, p)]
                 for m, nbr, c, p in diag["rounds"]]))[:len(ids)])
        torch.cuda.synchronize()
        return losses, np.concatenate(mets), np.concatenate(graphs)

    pairs = list(zip(ld, ld._batches))
    for fn in counters.values():        # (b) and (c) are the main path
        fn.launches = 0
    for key, part, ring in (("eval", pairs, False),
                            ("ring", pairs[:DRN_EP_RING_BATCHES], True)):
        t = time.perf_counter()
        losses, met, graphs = sharded_pass(part, ring)
        out[key] = dict(losses=losses, met=met, graphs=graphs,
                        seconds=time.perf_counter() - t)

    # (c) resumed train steps, node-sharded and (rank 0) single-device
    tcfg = drn_train_config(cfg)
    hosts = list(itertools.islice(iter(fetch_dataloader(
        events=smoke_events(), batch_size=DRN_TRAIN_B)["train"]),
        len(GOLDEN_DRN_TRAIN_LOSSES)))

    def resumed():
        m = tdrn.DRN(tcfg.drn, device=device)
        opt = make_optimizer(tcfg, m)
        restore_checkpoint(os.path.join(HERE, DRN_CKPTS, "best.ckpt"), m,
                           opt, ReduceLROnPlateau(lr=tcfg.optim.lr))
        return m, opt

    def digests(rounds):
        return drn_graph_digests(compacted_rounds(
            [[t.cpu().numpy() for t in r] for r in rounds]))

    m_ep, opt = resumed()
    step = mesh_train_step(tcfg, "drn", mesh, shard_nodes=True)
    match, build = tdrn.handshake_matching, tdyn.knn_graph_sharded
    step_s = []
    trace_dir = os.path.join(HERE, "build", "smoke", "mesh",
                             f"trace_rank{mesh.rank}")
    losses, graphs, replay, states = [], [], [], []
    t = time.perf_counter()
    for i, host in enumerate(hosts):
        rounds, lists = [], []

        def recorded(w, nbr, mask, *a, **kw):
            cluster, partner = match(w, nbr, mask, *a, **kw)
            rounds.append((mask, nbr.idx, nbr.mask, cluster, partner))
            return cluster, partner

        def built(h, m, **kw):      # the round's kNN lists, whole axis
            nb = build(h, m, **kw)
            lists.append(Neighborhood(*(torch.cat(mesh.all_gather(
                a, mesh.node_group), 1) for a in nb)))
            return nb

        b = to_device(shard_batch(host, mesh, True), device)
        last = i == len(hosts) - 1
        with mock.patch.object(tdrn, "handshake_matching", recorded), \
                mock.patch.object(tdyn, "knn_graph_sharded", built), \
                (profiling.trace(trace_dir) if last
                 else contextlib.nullcontext()) as prof:
            t_step = time.perf_counter()
            losses.append(float(step(m_ep, opt, b)))
            torch.cuda.synchronize()
            if not last:            # the traced step is profiled, not timed
                step_s.append(time.perf_counter() - t_step)
        graphs.append(digests(rounds))
        replay.append((lists, [r[3:] for r in rounds]))
        if mesh.rank == 0:
            states.append({p: v.detach().clone()
                           for p, v in m_ep.jax_layout()})
    sec = time.perf_counter() - t
    dev_ms, n_k, top = kernel_times(prof)
    out["train"] = dict(losses=losses, graphs=np.stack(graphs), seconds=sec,
                        step_times=dict(
                            steps=len(step_s),
                            p50_step_ms=1e3 * float(np.median(step_s)),
                            max_step_ms=1e3 * max(step_s)),
                        last_step_device_ms=dev_ms,
                        last_step_kernels=n_k, last_step_top=top,
                        trace=os.path.relpath(os.path.join(
                            trace_dir, "trace.json"), HERE))
    # (d) the DRN kernels on (b)-(c): the fused conv's, two per forward
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    steps = cfg.drn.pool_rounds * len(hosts)
    out["want_launches"] = dict(edge_mlp_fwd=cfg.drn.pool_rounds * (
        len(pairs) + DRN_EP_RING_BATCHES) + steps, edge_mlp_bwd=steps)
    if mesh.rank == 0:
        out["replay"] = drn_replay_steps(resumed, tcfg, hosts, replay,
                                         losses, states, device)
        m_s, opt_s = resumed()
        single = make_train_step(tcfg, lambda mm, bb: drn_loss_fn(
            tdrn.drn_net_apply(mm, bb, graph_force="composed"), bb, head))
        cut = tdrn.cut_matching
        s_losses, s_graphs = [], []
        for host in hosts:
            rounds = []

            def recorded(g, hh, mask, *a, **kw):
                cluster, partner = cut(g, hh, mask, *a, **kw)
                rounds.append((mask, g.nbr.idx, g.nbr.mask, cluster,
                               partner))
                return cluster, partner

            with mock.patch.object(tdrn, "cut_matching", recorded):
                s_losses.append(float(single(m_s, opt_s,
                                             to_device(host, device))))
            s_graphs.append(digests(rounds))
        out["single"] = dict(losses=s_losses, graphs=np.stack(s_graphs))
    return out


def mesh_rank_main(rank: int, store: str, out_dir: str) -> None:
    """A rank of the two-rank group (started by mesh_phases): gloo on the
    shared card, then the --mesh 2 and --mesh 1x2 train phases, the EP
    kernel check, both families' data-parallel evaluation and the
    node-sharded DRN (mesh_drn_ep_rank); its results into ``out_dir``."""
    import pickle

    import torch
    from torch import distributed as dist

    sys.path.insert(0, HERE)
    from deepmetv2_tpu_torch.parallel import multihost

    devices = multihost.rank_devices("cuda", 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(multihost.backend_for(devices), "file://" + store,
                         2, rank, devices[rank])
    try:
        out = dict(dp=mesh_train_rank(devices[rank], (2, 1)),
                   ep=mesh_train_rank(devices[rank], (1, 2)),
                   ep_kernel=mesh_window_rank(devices[rank]),
                   eval=mesh_eval_rank(devices[rank]),
                   drn_eval=mesh_drn_eval_rank(devices[rank]),
                   drn_ep=mesh_drn_ep_rank(devices[rank]))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def mesh_phases(work: str) -> dict:
    """mesh_dp_train, mesh_ep_train, mesh_evaluate, mesh_drn_evaluate and
    mesh_drn_ep: two ranks on this card (gloo, staged), spawned once for
    all of them.  Returns the f32 window launches of their main paths and
    the node-sharded DRN's fused-conv launches, summed over the ranks."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    out_dir = os.path.join(work, "mesh")
    os.makedirs(out_dir)
    store = os.path.join(tempfile.mkdtemp(dir=out_dir), "store")
    t = time.perf_counter()
    try:
        torch.multiprocessing.start_processes(
            mesh_rank_main, args=(store, out_dir), nprocs=2,
            start_method="spawn")
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException) as e:
        fail(f"a mesh rank failed: {e}")
    sec = time.perf_counter() - t
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    fwd = bwd = 0
    for key, mesh in (("dp", "--mesh 2"), ("ep", "--mesh 1x2")):
        a, b = ranks[0][key], ranks[1][key]
        rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                   GOLDEN_TRAIN_LOSSES)]
        say(f"mesh_{key}_train", mesh=mesh, layout=a["mesh"],
            losses=a["losses"], golden=GOLDEN_TRAIN_LOSSES,
            max_rel_err=max(rel), launches_by_rank=[a["launches"],
                                                    b["launches"]],
            want_launches=a["want"], seconds=[a["seconds"], b["seconds"]],
            spawn_seconds=sec, card=CARD)
        if a["losses"] != b["losses"]:
            fail(f"{mesh}: the ranks report different losses")
        if not max(rel) <= LOSS_RTOL:
            fail(f"{mesh}: resumed losses not within {LOSS_RTOL} of "
                 f"GOLDEN_TRAIN_LOSSES: {a['losses']}")
        for r, x in enumerate((a, b)):
            want = {"window_max": x["want"], "window_max_bwd": x["want"]}
            if {k: v for k, v in x["launches"].items() if v} != want:
                fail(f"{mesh}: rank {r} launched {x['launches']}, want "
                     f"{want}")
            check_embed_counts(f"{mesh}: rank {r}", x["steps"], x["steps"],
                               x["embed"])
            fwd += x["launches"]["window_max"]
            bwd += x["launches"]["window_max_bwd"]
    k = ranks[0]["ep_kernel"]
    say("mesh_ep_kernel", **k)
    if not (k["fwd_bitwise"] and k["padded_neg_inf"]):
        fail("the sharded window max is not bitwise the single-device "
             "kernel's on real rows (or not -inf on padded ones)")
    if not k["max_dc_diff"] <= GRAD_ATOL * k["max_abs_dc"]:
        fail(f"the sharded window max's gradient is {k['max_dc_diff']} from "
             f"the single-device kernel's (largest {k['max_abs_dc']})")
    ev = [x["eval"] for x in ranks]
    loss = ev[0]["loss"]
    say("mesh_evaluate", mesh="--mesh 2", loss=loss, golden=GOLDEN_LOSS,
        rel_err=abs(loss - GOLDEN_LOSS) / GOLDEN_LOSS,
        launches_by_rank=[e["launches"] for e in ev],
        seconds=[e["seconds"] for e in ev])
    if ev[1]["loss"] != loss:
        fail("mesh evaluate: the ranks report different losses")
    if not abs(loss - GOLDEN_LOSS) <= LOSS_RTOL * GOLDEN_LOSS:
        fail(f"mesh evaluate loss {loss} not within {LOSS_RTOL} of "
             f"{GOLDEN_LOSS}")
    for r, e in enumerate(ev):
        if {k: v for k, v in e["launches"].items() if v} != {
                "window_max": e["want"]}:
            fail(f"mesh evaluate: rank {r} launched {e['launches']}, want "
                 f"{e['want']} window_max")
        check_embed_counts(f"mesh evaluate: rank {r}", e["batches"], 0,
                           e["embed"])
        fwd += e["launches"]["window_max"]
    d = [x["drn_eval"] for x in ranks]
    if not (d[0]["same_met"] and d[1]["same_met"]):
        fail("mesh DRN evaluate: the recorded pass's MET is not the mesh "
             "step's")
    if any(any(x["launches"].values()) for x in d):
        fail(f"mesh DRN evaluate launched {[x['launches'] for x in d]}")
    from deepmetv2_tpu_torch.cli.common import load_run_config

    ld = drn_val_loader(load_run_config(os.path.join(HERE, DRN_CKPTS)), 8)
    n = sum(len(ids) for ids in ld._batches)
    half = d[0]["digests"].shape[1]
    graphs = np.concatenate([np.concatenate([d[0]["digests"][i],
                                             d[1]["digests"][i]])
                             for i in range(len(d[0]["digests"]))])
    met = d[0]["met"].reshape(-1, 2)
    keep = np.concatenate([np.arange(len(ids)) + i * 2 * half
                           for i, ids in enumerate(ld._batches)])
    drn_golden_rule("mesh_drn_evaluate", ld, d[0]["losses"], met[keep][:n],
                    graphs[keep][:n], GOLDEN_DRN_COMPOSED_MET,
                    GOLDEN_DRN_COMPOSED_GRAPHS, mesh="--mesh 2",
                    golden_loss=GOLDEN_DRN_COMPOSED_LOSS,
                    seconds=[x["seconds"] for x in d])
    drn = mesh_drn_ep_report([x["drn_ep"] for x in ranks], ld, sec)
    return dict(fwd=fwd, bwd=bwd, drn_fwd=drn["edge_mlp_fwd"],
                drn_bwd=drn["edge_mlp_bwd"])


def mesh_drn_ep_report(parts, ld, spawn_seconds: float) -> None:
    """mesh_drn_ep: the lines of mesh_drn_ep_rank's sub-phases from both
    ranks' ``parts``, and their checks: (a) each build's masks equal to
    knn_graph's, its neighbour sets on every row without a near tie at the
    k-th place, the two builds bitwise on every row without an exact tie
    (knn_tie_rows); (b) the validation
    pass by drn_golden_rule against the composed golden, both ranks' MET
    bitwise equal, the ring's MET bitwise the all-gather pass's on every
    event whose graphs agree; (c) the ranks' losses equal, step 0 within
    DRN_EP_STEP0_RTOL of the composed single-device step where every
    event's graphs agree, every step within DRN_TRAIN_LATE_RTOL of it, and
    every step's loss and model within DRN_EP_REPLAY_RTOL of the
    single-device step on the same graphs (drn_replay_steps); (d) each
    rank's launches those of the fused conv, two per forward
    (``want_launches``), and none of the graph kernels.  Returns the
    fused conv's launches summed over the ranks."""
    import numpy as np

    secs = {key: [p[key]["seconds"] for p in parts]
            for key in ("knn", "eval", "ring", "train")}
    k = parts[0]["knn"]
    say("mesh_drn_ep", sub="knn", mesh="1x2", card=CARD,
        **{key: v for key, v in k.items() if key != "seconds"},
        seconds_by_rank=secs["knn"])
    if not all(k["masks_equal"].values()):
        fail(f"node-sharded kNN: slot masks unlike knn_graph's "
             f"{k['masks_equal']}")
    if any(k["set_rows_differ"].values()):
        fail(f"node-sharded kNN: neighbour sets unlike knn_graph's on rows "
             f"without a tie at the k-th place: {k['set_rows_differ']}")
    if k["ring_rows_differ"]:
        fail(f"node-sharded kNN: the ring build differs from the all-gather "
             f"build on {k['ring_rows_differ']} rows without a tie")

    ev = [p["eval"] for p in parts]
    if not (np.array_equal(ev[0]["met"], ev[1]["met"])
            and ev[0]["losses"] == ev[1]["losses"]):
        fail("node-sharded DRN evaluate: the ranks' outputs differ")
    ring = parts[0]["ring"]
    n = len(ring["met"])
    same = (ring["graphs"] == ev[0]["graphs"][:n]).all(axis=1)
    equal = (ring["met"] == ev[0]["met"][:n]).all(axis=1)
    drn_golden_rule("mesh_drn_ep", ld, ev[0]["losses"], ev[0]["met"],
                    ev[0]["graphs"], GOLDEN_DRN_COMPOSED_MET,
                    GOLDEN_DRN_COMPOSED_GRAPHS, sub="evaluate", mesh="1x2",
                    golden_loss=GOLDEN_DRN_COMPOSED_LOSS,
                    seconds_by_rank=secs["eval"], card=CARD)
    say("mesh_drn_ep", sub="ring", mesh="1x2", events=int(n),
        events_with_the_all_gather_graphs=int(same.sum()),
        met_bitwise_on_those=bool(equal[same].all()),
        seconds_by_rank=secs["ring"], card=CARD)
    if not equal[same].all():
        fail("node-sharded DRN evaluate: the ring build's MET is not the "
             "all-gather build's on events with the same graphs")

    tr, single = [p["train"] for p in parts], parts[0]["single"]
    agree = [bool(np.array_equal(a, b)) for a, b in
             zip(tr[0]["graphs"], single["graphs"])]
    rel = [abs(a - b) / abs(b) for a, b in zip(tr[0]["losses"],
                                               single["losses"])]
    say("mesh_drn_ep", sub="train", mesh="1x2", losses=tr[0]["losses"],
        single_device_composed=single["losses"], rel_err=rel,
        steps_with_the_same_graphs=[i for i, a in enumerate(agree) if a],
        events_with_other_graphs=[int((a != b).any(-1).sum()) for a, b in
                                  zip(tr[0]["graphs"], single["graphs"])],
        step_times_by_rank=[t["step_times"] for t in tr],
        last_step_device_ms_by_rank=[t["last_step_device_ms"] for t in tr],
        last_step_kernels=tr[0]["last_step_kernels"],
        last_step_top=tr[0]["last_step_top"], trace=tr[0]["trace"],
        seconds_by_rank=secs["train"], spawn_seconds=spawn_seconds,
        card=CARD)
    rp = parts[0]["replay"]
    say("mesh_drn_ep", sub="train_replay", mesh="1x2",
        loss_rel_err=rp["loss_rel_err"],
        worst_over_allowance=rp["worst_over_allowance"],
        worst_tensor=rp["worst_tensor"], lr=rp["lr"],
        rtol=DRN_EP_REPLAY_RTOL, card=CARD)
    if tr[0]["losses"] != tr[1]["losses"]:
        fail("node-sharded DRN train: the ranks report different losses")
    for i, (r, w) in enumerate(zip(rp["loss_rel_err"],
                                   rp["worst_over_allowance"])):
        if not (r <= DRN_EP_REPLAY_RTOL and w <= 1.0):
            fail(f"node-sharded DRN train step {i}: against the "
                 f"single-device step on the same graphs the loss is {r} "
                 f"off and {rp['worst_tensor'][i]} {w} times its allowance "
                 f"(DRN_EP_REPLAY_RTOL {DRN_EP_REPLAY_RTOL})")
    for i, r in enumerate(rel):
        lim = DRN_EP_STEP0_RTOL if i == 0 and agree[0] else \
            DRN_TRAIN_LATE_RTOL
        if not r <= lim:
            fail(f"node-sharded DRN train step {i}: loss "
                 f"{tr[0]['losses'][i]} is {r} from the single-device "
                 f"composed step's {single['losses'][i]}, not within {lim}")

    launches = [p["launches"] for p in parts]
    want = parts[0]["want_launches"]
    say("mesh_drn_ep", sub="launches", mesh="1x2", launches_by_rank=launches,
        want_by_rank=want, card=CARD)
    for r, c in enumerate(launches):
        if {k: v for k, v in c.items() if v} != want:
            fail(f"node-sharded DRN: rank {r} launched {c}, want {want}")
    return {k: sum(c[k] for c in launches) for k in want}


def mesh_drn_cli_phase(device, work: str) -> None:
    """mesh_drn_ep, sub-phase cli: the train CLI with --model drn --mesh
    1x2 --ring_knn for 1 epoch on DRN_EP_CLI_EVENTS synthetic events, as a
    user starts it (it spawns its 2 ranks, which share this card through
    gloo): its mesh line, each rank's launches those of the fused conv
    (the backward's as many as the forward's, no graph kernel), and
    best.ckpt re-evaluated within REEVAL_RTOL by the single-device
    evaluation of the path the mesh evaluates with (DRN_MESH_FORCES).
    Returns the fused conv's launches summed over the ranks."""
    import torch
    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import fetch_dataloader
    from deepmetv2_tpu_torch.models.drn import DRN, drn_net_apply
    from deepmetv2_tpu_torch.parallel.dp import DRN_MESH_FORCES
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint
    from deepmetv2_tpu_torch.train.loop import evaluate
    from deepmetv2_tpu_torch.train.loss import drn_loss_fn, drn_met_vector

    ck = os.path.join(work, "mesh_drn_cli")
    cmd = [sys.executable, "-m", "deepmetv2_tpu_torch.cli.train", "--model",
           "drn", "--drn_head", "cartesian", "--synthetic",
           str(DRN_EP_CLI_EVENTS), "--batch_size", "8", "--epochs", "1",
           "--mesh", "1x2", "--ring_knn", "--device", device.type,
           "--ckpts", ck]
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    sec = time.perf_counter() - t
    if r.returncode != 0:
        fail(f"train CLI --model drn --mesh 1x2 --ring_knn exited "
             f"{r.returncode}:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    lines = r.stdout.splitlines()
    counts = json.loads([ln for ln in lines if ln.startswith(
        "launches by rank:")][0].split(":", 1)[1])
    with open(os.path.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    cfg = load_run_config(ck)
    payload = load_checkpoint(os.path.join(ck, "best.ckpt"))
    model = DRN(cfg.drn, device=device).params_from_jax(
        payload["params"], payload["bn_state"])
    head = cfg.drn.head

    @torch.no_grad()
    def step(m, b):
        pred = drn_net_apply(m.eval(), b, **DRN_MESH_FORCES)
        return drn_met_vector(pred, head), drn_loss_fn(pred, b, head), None

    ld = fetch_dataloader(events=smoke_events(DRN_EP_CLI_EVENTS),
                          batch_size=8, buckets=cfg.data.node_buckets)
    got = evaluate(model, step, ld["test"], cfg, device,
                   verbose=False)[0]["loss"]
    rel = abs(got - best) / abs(best)
    say("mesh_drn_ep", sub="cli", argv=cmd[3:], seconds=sec,
        launches_by_rank=counts, epoch_seconds=epoch_seconds(r.stdout),
        metrics_val_best=best, reevaluated=got, rel_err=rel, card=CARD,
        log=[ln for ln in lines if ln.startswith(
            ("mesh:", "feed:", "Training epoch", "- Eval"))])
    if not any(ln.startswith("mesh: 1 data x 2 node over 2 ranks")
               and ln.endswith("(node-sharded DRN, ring kNN)")
               for ln in lines):
        fail("train CLI --model drn --mesh 1x2 --ring_knn did not print its "
             "node-sharded ring mesh line")
    for c in counts:
        fwd = c["edge_mlp_fwd"]
        if not (fwd > 0 and fwd % cfg.drn.pool_rounds == 0
                and {k: v for k, v in c.items() if v} == {
                    "edge_mlp_fwd": fwd, "edge_mlp_bwd": fwd}):
            fail(f"train CLI --model drn --mesh 1x2: a rank launched "
                 f"{counts}, want edge_mlp_fwd and edge_mlp_bwd alike")
    if not rel <= REEVAL_RTOL:
        fail(f"the --mesh 1x2 DRN run's best.ckpt re-evaluates to {got}, "
             f"not within {REEVAL_RTOL} of its metrics_val_best.json {best}")
    return {k: sum(c[k] for c in counts)
            for k in ("edge_mlp_fwd", "edge_mlp_bwd")}


def mesh_world1_phase(device, work: str) -> dict:
    """--mesh 1 on NCCL in this process: 3 resumed data-parallel steps
    against 3 single-device steps on the same batches, losses, parameters,
    BatchNorm buffers and AdamW state bitwise."""
    import torch
    from torch import distributed as dist
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.parallel import multihost
    from deepmetv2_tpu_torch.parallel.dp import make_dp_train_step
    from deepmetv2_tpu_torch.parallel.mesh import Mesh
    from deepmetv2_tpu_torch.train.step import make_train_step

    os.makedirs(os.path.join(work, "mesh_world1"))
    store = os.path.join(work, "mesh_world1", "store")
    devices = multihost.rank_devices(device, 1)
    backend = multihost.backend_for(devices)
    multihost.initialize(backend, "file://" + store, 1, 0, devices[0])
    try:
        mesh = Mesh(1, 1, device=devices[0])
        runs = []
        for make in (make_train_step, lambda cfg: make_dp_train_step(cfg,
                                                                     mesh)):
            model, opt, cfg, hosts = mesh_resume_setup(device)
            step = make(cfg)
            window_counts(zero=True)
            embed_counts(zero=True)
            losses = torch.stack([step(model, opt, to_device(h, device))
                                  for h in hosts[:3]])
            runs.append((losses, train_state(model, opt)))
        launches, embed = window_counts(), embed_counts()  # the mesh run's
    finally:
        dist.destroy_process_group()
    (la, sa), (lb, sb) = runs
    diff = run_differ(la, sa, lb, sb)
    say("mesh_world1", mesh="--mesh 1", backend=backend,
        layout=mesh.describe(), losses=la.tolist(), differ=diff,
        launches=launches)
    if backend != "nccl":
        fail(f"--mesh 1 on one card took {backend}, not nccl")
    if any(diff.values()):
        fail(f"--mesh 1 is not bitwise the single-device step: {diff}")
    if launches["window_max"] != 6 or launches["window_max_bwd"] != 6:
        fail(f"--mesh 1 launched {launches}, want 6 of each f32 kernel")
    check_embed_counts("--mesh 1", 3, 3, embed)
    return dict(fwd=launches["window_max"], bwd=launches["window_max_bwd"])


def mesh_cli_phase(work: str) -> dict:
    """The train CLI with --mesh 1x2 for 1 epoch on MESH_CLI_EVENTS
    synthetic events, as a user starts it (it
    spawns its 2 ranks, which share this card through gloo): its mesh and
    feed lines, each rank's exact window launches (the overlap or serial
    schedule of each batch's shard) and embedding launches (one forward a
    batch, one backward a train batch), the artifacts, and best.ckpt
    re-evaluated by the evaluate CLI within REEVAL_RTOL."""
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.data import fetch_dataloader

    ck = os.path.join(work, "mesh_cli")
    cmd = [sys.executable, "-m", "deepmetv2_tpu_torch.cli.train",
           "--synthetic", str(MESH_CLI_EVENTS), "--batch_size", str(TRAIN_B),
           "--epochs", "1", "--mesh", "1x2", "--ckpts", ck]
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    sec = time.perf_counter() - t
    lines = r.stdout.splitlines()
    if r.returncode != 0:
        fail(f"train CLI --mesh 1x2 exited {r.returncode}:\n"
             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    gm = graph_mode(r.stdout)
    if gm is None or gm[2] != "eta":
        fail(f"train CLI --mesh 1x2 printed graph mode {gm}, not order eta")
    halo = gm[0]
    counts = json.loads([ln for ln in lines if ln.startswith(
        "launches by rank:")][0].split(":", 1)[1])
    ld = fetch_dataloader(events=smoke_events(MESH_CLI_EVENTS),
                          batch_size=TRAIN_B, presort_eta=True,
                          presort_mode="eta")
    convs = 2
    per = sum(ep_launches_per_conv(b.x_cont.shape[1], 2, halo)
              for b in ld["train"]) * convs
    want = {"window_max": per + convs * len(ld["test"]),
            "window_max_bwd": per,
            "cat_embed_fwd": len(ld["train"]) + len(ld["test"]),
            "cat_embed_bwd": len(ld["train"])}
    say("mesh_cli", argv=cmd[3:], seconds=sec, launches_by_rank=counts,
        want=want, epoch_seconds=epoch_seconds(r.stdout), card=CARD,
        log=[ln for ln in lines if ln.startswith(
            ("graph mode", "mesh:", "feed:", "Training epoch", "- Eval"))])
    if "feed: resident, chain 8, eager (mesh)" not in lines:
        fail("train CLI --mesh 1x2 did not print its eager mesh feed")
    if not any(ln.startswith("mesh: 1 data x 2 node over 2 ranks, backend "
                             "gloo, collectives staged") for ln in lines):
        fail("train CLI --mesh 1x2 did not print its staged gloo mesh")
    for rank, c in enumerate(counts):
        if {k: v for k, v in c.items() if v} != want:
            fail(f"train CLI --mesh 1x2: rank {rank} launched {c}, want "
                 f"{want}")
        check_embed_counts(f"train CLI --mesh 1x2: rank {rank}",
                           want["cat_embed_fwd"], want["cat_embed_bwd"],
                           {k: c[k] for k in EMBED_MAIN})
    with open(os.path.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    ev = os.path.join(work, "mesh_cli_eval")
    os.makedirs(ev)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(ck, f), ev)
    got = evaluate_cli.run(["--synthetic", str(MESH_CLI_EVENTS), "--ckpts",
                            ev, "--batch_size", str(TRAIN_B)])["loss"]
    rel = abs(got - best) / abs(best)
    say("mesh_cli_reeval", metrics_val_best=best, evaluate_cli=got,
        rel_err=rel)
    if not rel <= REEVAL_RTOL:
        fail(f"evaluate CLI gives {got} on the --mesh 1x2 run's best.ckpt, "
             f"not within {REEVAL_RTOL} of its metrics_val_best.json {best}")
    return dict(fwd=sum(c["window_max"] for c in counts),
                bwd=sum(c["window_max_bwd"] for c in counts))


def etl_make_data(work: str) -> str:
    """(a) the chunks of ETL_CHUNKS through the port's ETL CLI, run as a
    user runs it (a subprocess per mode); every slice's name and the
    digests of its arrays against GOLDEN_ETL_DIGESTS.  Returns the data
    directory (slices under raw/)."""
    import pickle

    import numpy as np

    d = os.path.join(work, "etl")
    data = os.path.join(d, "data")
    os.makedirs(d)
    t = time.perf_counter()
    paths = {"dytt": [], "znunu": []}
    for i, (mode, n) in enumerate(ETL_CHUNKS):
        path = os.path.join(d, f"chunk{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump(etl_chunk(ETL_SEED + i, n, mode == "dytt"), f)
        paths[mode].append(path)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    for mode, inputs in paths.items():
        r = subprocess.run(
            [sys.executable, "-m", "deepmetv2_tpu_torch.etl.generate_npz",
             "--mode", mode, "--input", *inputs, "--out",
             os.path.join(data, "raw"), "--dataset", mode],
            cwd=HERE, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            fail(f"ETL CLI --mode {mode} exited {r.returncode}:\n"
                 f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    etl_s = time.perf_counter() - t
    got = {}
    for name in sorted(os.listdir(os.path.join(data, "raw"))):
        with np.load(os.path.join(data, "raw", name)) as z:
            got[name] = (etl_array_digest(z["x"]), etl_array_digest(z["y"]))
    say("etl_data", step="etl", numpy=np.__version__, chunks=ETL_CHUNKS,
        pf_per_event=ETL_PF, slices=list(got), chunk_seconds=gen_s,
        etl_seconds=etl_s,
        digests_equal={k: got.get(k) == v
                       for k, v in GOLDEN_ETL_DIGESTS.items()})
    if got != GOLDEN_ETL_DIGESTS:
        fail(f"the ETL's slices {got} are not GOLDEN_ETL_DIGESTS")
    return data


def etl_host_seconds(data: str) -> dict:
    """The train CLI's host work on the ETL'd slices: collating the train
    split's batches, collating and cell-sorting them, and sizing the halo
    on the sorted batches, with the seconds of each and per batch."""
    from deepmetv2_tpu_torch.data import fetch_dataloader

    kw = dict(data_dir=data, batch_size=TRAIN_B)
    t = time.perf_counter()
    plain = fetch_dataloader(**kw)["train"]
    n = len(list(plain))
    collate_s = time.perf_counter() - t
    ld = fetch_dataloader(presort_eta=True, presort_mode="cell", **kw)
    t = time.perf_counter()
    list(ld["train"])
    sorted_s = time.perf_counter() - t
    with contextlib.redirect_stdout(io.StringIO()):
        t = time.perf_counter()
        ld["train"].required_halo(R)
        halo_s = time.perf_counter() - t
    return {"batches": n, "buckets": ld["train"].batches_per_bucket(),
            "collate_s": collate_s, "collate_cell_sort_s": sorted_s,
            "cell_sort_s_per_batch": (sorted_s - collate_s) / n,
            "halo_sizing_s": halo_s, "halo_sizing_s_per_batch": halo_s / n}


def etl_train_loaders(data: str):
    """The train CLI's cell-sorted loaders over the slices and its config
    (halo sized on both, presorted)."""
    import argparse

    from deepmetv2_tpu_torch.cli.common import apply_graph_mode, load_run_config
    from deepmetv2_tpu_torch.data import fetch_dataloader

    lds = fetch_dataloader(data_dir=data, batch_size=TRAIN_B,
                           presort_eta=True, presort_mode="cell")
    cfg = load_run_config(os.path.join(HERE, "ckpts_syn"))
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = apply_graph_mode(cfg, argparse.Namespace(graph_mode="window"),
                               lds["train"].dataset, presorted=True,
                               loaders=[lds["train"], lds["test"]])
    if cfg.graph.window_halo != GOLDEN_ETL_TRAIN_HALO:
        fail(f"the train CLI's halo on the ETL'd slices is "
             f"{cfg.graph.window_halo}, not {GOLDEN_ETL_TRAIN_HALO}")
    return lds, cfg


def etl_kernel_phase(device, lds, cfg):
    """(b) window_max_fwd and window_max_bwd on the largest cell-sorted
    train batch of the ETL'd slices (N=8192, the train CLI's halo),
    bitwise against their plain versions on every row, padded rows -inf /
    0; each kernel's time, the plain version's, its bound and the chunks
    the prune keeps.  Returns the batch on the device."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)
    from deepmetv2_tpu_torch.ops.window import (padded_pos, padded_rows,
                                                window_max_bwd_torch,
                                                window_max_torch)
    from deepmetv2_tpu_torch.train.step import window_graph

    halo, r2, H = cfg.graph.window_halo, R ** 2, cfg.model.hidden_dim
    host = max(lds["train"], key=lambda b: (b.max_nodes, int(b.mask.sum())))
    batch = to_device(host, device)
    B, N = batch.mask.shape
    if N != 8192:
        fail(f"the largest ETL'd train batch is at N={N}, not 8192")
    pos = padded_pos(window_graph(batch, cfg).etaphi, batch.mask)
    real = ~padded_rows(pos)
    rng = np.random.default_rng(13)
    c = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32),
                        device=device)
    g = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32),
                        device=device) * real[..., None]
    m = window_max(c, pos, r2, halo)
    mt = window_max_torch(c, pos, real, r2, halo)
    dk = window_max_bwd(c, pos, m, g, r2, halo)
    dt = window_max_bwd_torch(c, pos, m, g, r2, halo)
    torch.cuda.synchronize()
    if not bitwise_equal(m, mt):
        fail(f"window_max at the ETL shape: {n_differ(m, mt)} entries "
             "differ from the plain version")
    if bool((m[~real] != float("-inf")).any()):
        fail("window_max at the ETL shape: a padded row is not -inf")
    if not bitwise_equal(dk, dt):
        fail(f"window_max_bwd at the ETL shape: {n_differ(dk, dt)} entries "
             "differ from the plain version")
    if bool((dk[~real] != 0).any()):
        fail("window_max_bwd at the ETL shape: a padded row is not 0")
    fin = torch.isfinite(mt)
    pairs, adj = window_work(pos, real, halo, r2)
    kept, chunks, blocks = chunk_counts(pos, halo, r2)
    out = {}
    for name, fn, plain, reads, ops in (
            ("window_max_fwd", lambda: window_max(c, pos, r2, halo),
             lambda: window_max_torch(c, pos, real, r2, halo), 1,
             6 * pairs + H * adj),
            ("window_max_bwd",
             lambda: window_max_bwd(c, pos, m, g, r2, halo),
             lambda: window_max_bwd_torch(c, pos, m, g, r2, halo), 3,
             6 * pairs + 2 * H * adj)):
        nbytes = window_bytes(pos, H, reads)
        bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
        out[name] = {"ms": cuda_ms(fn, 20), "plain_ms": cuda_ms(plain, 2),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "fp32_ops": ops,
                     "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops}
    say("etl_data", step="kernels", cases="fwd,bwd bitwise equal",
        shape=[B, N, H], halo=halo, real_rows=int(real.sum()),
        max_abs_err=float((m[fin] - mt[fin]).abs().max()),
        window_pairs=pairs, adjacent_pairs=adj, kept_chunks=kept,
        window_chunks=chunks, blocks_with_real_rows=blocks, card=CARD, **out)
    return batch


def etl_evaluate_phase(work: str, data: str) -> int:
    """(c) the evaluate CLI on the slices with ckpts_syn/best.ckpt: its
    "graph mode:" line (the halo against GOLDEN_ETL_HALO), the loss within
    LOSS_RTOL of GOLDEN_ETL_LOSS, the exact window launches.  Returns the
    forward launches."""
    import torch
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)

    ck = ckpt_copy(work, "etl_eval")
    window_max.launches = window_max_bwd.launches = 0
    embed_counts(zero=True)
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        loss = evaluate_cli.run(["--data", data, "--ckpts", ck])["loss"]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    gm = graph_mode(out.getvalue())
    n_batches = sum(gm[1]["test"].values()) if gm else 0
    rel = abs(loss - GOLDEN_ETL_LOSS) / GOLDEN_ETL_LOSS
    say("etl_data", step="evaluate", loss=loss, golden=GOLDEN_ETL_LOSS,
        rel_err=rel, graph_mode=gm, launches=window_max.launches,
        bwd_launches=window_max_bwd.launches, seconds=sec)
    if gm is None or gm[0] != GOLDEN_ETL_HALO:
        fail(f"evaluate on the ETL'd slices sized graph mode {gm}, not halo "
             f"{GOLDEN_ETL_HALO}")
    if not rel <= LOSS_RTOL:
        fail(f"evaluate on the ETL'd slices: loss {loss} is not within "
             f"{LOSS_RTOL} of {GOLDEN_ETL_LOSS}")
    if (window_max.launches, window_max_bwd.launches) != (2 * n_batches, 0):
        fail(f"evaluate on the ETL'd slices launched window_max "
             f"{window_max.launches} and its backward "
             f"{window_max_bwd.launches} times; want {2 * n_batches}, 0")
    check_embed_counts("evaluate on the ETL'd slices", n_batches, 0)
    return window_max.launches


def etl_train_resume_phase(device, lds, cfg):
    """(d) the first 10 cell-sorted train batches of the slices, 10 train
    steps resumed from ckpts_syn/best.ckpt through the chained runner
    (chain_batches: runs of up to 8 same-shape batches), each loss within
    LOSS_RTOL of GOLDEN_ETL_TRAIN_LOSSES, exact launches.  Returns
    (forward, backward) launches."""
    import itertools

    from deepmetv2_tpu_torch.data import to_device
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)
    from deepmetv2_tpu_torch.train.chain import (chain_batches, chain_length,
                                                 make_chained_train_step)
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.step import make_optimizer

    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(cfg, model)
    restore_checkpoint(os.path.join(HERE, "ckpts_syn", "best.ckpt"), model,
                       opt)
    hosts = list(itertools.islice(iter(lds["train"]),
                                  len(GOLDEN_ETL_TRAIN_LOSSES)))
    runner = make_chained_train_step(cfg)
    window_max.launches = window_max_bwd.launches = 0
    embed_counts(zero=True)
    losses, chains = [], []
    t = time.perf_counter()
    for stacked in chain_batches(iter(hosts), cfg.train.chain_steps):
        chains.append([chain_length(stacked), stacked.mask.shape[-1]])
        losses += runner(model, opt, to_device(stacked, device)).tolist()
    sec = time.perf_counter() - t
    rel = [abs(a - b) / abs(b) for a, b in zip(losses,
                                               GOLDEN_ETL_TRAIN_LOSSES)]
    n = 2 * len(hosts)
    say("etl_data", step="train_resume", halo=cfg.graph.window_halo,
        chains=chains, losses=losses, golden=GOLDEN_ETL_TRAIN_LOSSES,
        rel_err=rel, max_rel_err=max(rel), launches=window_max.launches,
        bwd_launches=window_max_bwd.launches, seconds=sec)
    if not max(rel) <= LOSS_RTOL:
        fail(f"resumed train losses on the ETL'd slices are not within "
             f"{LOSS_RTOL} of the JAX package's: {losses}")
    if (window_max.launches, window_max_bwd.launches) != (n, n):
        fail(f"the resumed steps launched window_max {window_max.launches} "
             f"and its backward {window_max_bwd.launches} times; want {n}")
    check_embed_counts("the resumed steps on the ETL'd slices", len(hosts),
                       len(hosts))
    return window_max.launches, window_max_bwd.launches


def etl_train_phase(work: str, data: str, lds):
    """(e) the train CLI on the slices for 1 epoch, chained and resident:
    its "feed:" and "graph mode:" lines (the halo, each loader's batches
    per bucket), the exact launches with replays, its best.ckpt
    re-evaluated by the evaluate CLI within REEVAL_RTOL.  Returns
    (forward, backward) launches."""
    import torch
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import train as train_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)

    per = {k: lds[k].batches_per_bucket() for k in ("train", "test")}
    steps, evals = len(lds["train"]), len(lds["test"])
    ck = os.path.join(work, "etl_train")
    window_max.launches = window_max_bwd.launches = 0
    embed_counts(zero=True)
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(["--data", data, "--batch_size", str(TRAIN_B),
                             "--epochs", "1", "--ckpts", ck])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    text = out.getvalue()
    gm = graph_mode(text)
    fwd, bwd = window_max.launches, window_max_bwd.launches
    embed = embed_counts()
    say("etl_data", step="train", seconds=sec, graph_mode=gm,
        fwd_launches=fwd, bwd_launches=bwd, epoch_seconds=epoch_seconds(text),
        log=[ln for ln in text.splitlines()
             if ln.startswith(("feed:", "Training epoch", "- Eval"))])
    if rc != 0:
        fail(f"train CLI on the ETL'd slices exited {rc}")
    check_feed_line("train CLI on the ETL'd slices", text)
    if gm != (GOLDEN_ETL_TRAIN_HALO, per, "cell"):
        fail(f"train CLI on the ETL'd slices printed graph mode {gm}, not "
             f"halo {GOLDEN_ETL_TRAIN_HALO}, {per}, order cell")
    if (fwd, bwd) != (2 * (steps + evals), 2 * steps):
        fail(f"train CLI on the ETL'd slices: launches forward {fwd}, "
             f"backward {bwd}; want {2 * (steps + evals)}, {2 * steps}")
    check_embed_counts("train CLI on the ETL'd slices", steps + evals, steps,
                       embed)
    with open(os.path.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    ev = os.path.join(work, "etl_train_eval")
    os.makedirs(ev)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(ck, f), ev)
    with contextlib.redirect_stdout(io.StringIO()):
        got = evaluate_cli.run(["--data", data, "--ckpts", ev,
                                "--batch_size", str(TRAIN_B)])["loss"]
    rel = abs(got - best) / abs(best)
    say("etl_data", step="train_reeval", metrics_val_best=best,
        evaluate_cli=got, rel_err=rel)
    if not rel <= REEVAL_RTOL:
        fail(f"evaluate CLI gives {got} on the ETL train CLI's best.ckpt, "
             f"not within {REEVAL_RTOL} of its metrics_val_best.json {best}")
    return fwd, bwd


def etl_profile_phase(device, data: str, batch, cfg) -> None:
    """(f) one train step on the largest cell-sorted train batch and one
    evaluation step on the first validation batch of the evaluate CLI
    (40 events, eta order on the device, GOLDEN_ETL_HALO), both at the
    8192 bucket: step time from CUDA events, device time and the top
    kernels from torch.profiler, the idle share; the host's seconds for
    collating, cell-sorting and halo sizing (etl_host_seconds)."""
    import dataclasses

    from deepmetv2_tpu_torch.data import fetch_dataloader, to_device
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.step import (make_eval_step,
                                                make_optimizer,
                                                make_train_step)

    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(cfg, model)
    restore_checkpoint(os.path.join(HERE, "ckpts_syn", "best.ckpt"), model,
                       opt)
    train_step = make_train_step(cfg)
    step_ms = cuda_ms(lambda: train_step(model, opt, batch), 10)
    dev_ms, n_k, top = step_profile(lambda: train_step(model, opt, batch), 3)
    say("etl_data", step="profile_train", batch=list(batch.mask.shape),
        halo=cfg.graph.window_halo, step_ms=step_ms, device_ms=dev_ms,
        device_idle_share=1 - dev_ms / step_ms, kernels_per_step=n_k,
        top=top, card=CARD)
    ecfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, window_halo=GOLDEN_ETL_HALO, presorted=False))
    ebatch = to_device(next(iter(fetch_dataloader(
        data_dir=data, batch_size=40)["test"])), device)
    eval_step = make_eval_step(ecfg)
    step_ms = cuda_ms(lambda: eval_step(model, ebatch), 10)
    dev_ms, n_k, top = step_profile(lambda: eval_step(model, ebatch), 3)
    say("etl_data", step="profile_eval", batch=list(ebatch.mask.shape),
        halo=GOLDEN_ETL_HALO, step_ms=step_ms, device_ms=dev_ms,
        device_idle_share=1 - dev_ms / step_ms, kernels_per_step=n_k,
        top=top, card=CARD)
    say("etl_data", step="profile_host", **etl_host_seconds(data))


def etl_data_phase(device, work: str) -> dict:
    """The real-data path at CMS-scale event sizes, (a)-(f) above; returns
    the window kernels' launches on it (``fwd``, ``bwd``)."""
    t = time.perf_counter()
    data = etl_make_data(work)
    lds, cfg = etl_train_loaders(data)
    batch = etl_kernel_phase(device, lds, cfg)
    fwd = etl_evaluate_phase(work, data)
    rf, rb = etl_train_resume_phase(device, lds, cfg)
    tf, tb = etl_train_phase(work, data, lds)
    etl_profile_phase(device, data, batch, cfg)
    say("etl_data", step="done", seconds=time.perf_counter() - t)
    return {"fwd": fwd + rf + tf, "bwd": rb + tb}


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
    embed_fwd, embed_bwd = kernel_cat_embed_phase(device)

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
    embed_counts(zero=True)
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
    check_embed_counts("evaluate", 10, 0)
    res = artifacts.load(os.path.join(ck, "best.resolutions"))
    if "MET" not in res:
        fail("best.resolutions holds no MET entry")

    # 6. main path: predict
    out = os.path.join(work, "pred.npz")
    window_max.launches = 0
    embed_counts(zero=True)
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
    check_embed_counts("predict", 50, 0)

    # 7. resume from the JAX checkpoint, held to the JAX losses; replayed
    # chains against eager steps
    train_resume_phase(device)
    chain_replay_phase(device, "graphmet")

    # 8. main path: the train CLI
    train_fwd, train_bwd = train_phase(work)

    # 8a. the real-data path: NanoAOD-shaped chunks through the ETL CLI,
    # the window kernels at N=8192 and the data's halo, evaluate, resumed
    # steps, the train CLI, profiles
    etl = etl_data_phase(device, work)

    # 8b. neighbor_list mode: evaluate, predict, --from_torch in both modes,
    # resumed chained steps, the train CLI
    nl_loss = nl_evaluate_phase(work)
    nl_predict_phase(work)
    from_torch_phase(work, metrics["loss"], nl_loss)
    nl_train_resume_phase(device)
    nl_train_phase(work)

    # 8c. bf16 compute (ckpts_syn_bf16): both bf16 kernels against their
    # plain versions, then evaluate, resumed chained steps and the train CLI
    fwd_bf16, bwd_bf16 = kernel_bf16_phase(device)
    bf16_eval_launches = bf16_evaluate_phase(work)
    bf16_train_resume_phase(device)
    bf16_train_fwd, bf16_train_bwd = bf16_train_phase(work)

    # 8d. the mesh: --mesh 2 and --mesh 1x2 on two ranks sharing this card
    # (resumed steps, the sharded window max against the kernel, both
    # families' evaluation), --mesh 1 on NCCL, the train CLI with --mesh 1x2
    mesh_runs = [mesh_phases(work), mesh_world1_phase(device, work),
                 mesh_cli_phase(work)]
    drn_cli = mesh_drn_cli_phase(device, work)
    mesh_fwd = sum(m["fwd"] for m in mesh_runs)
    mesh_bwd = sum(m["bwd"] for m in mesh_runs)
    mesh_drn_fwd = mesh_runs[0]["drn_fwd"] + drn_cli["edge_mlp_fwd"]
    mesh_drn_bwd = mesh_runs[0]["drn_bwd"] + drn_cli["edge_mlp_bwd"]

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
    profile_phase(device, os.path.join(work, "bf16"))
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

    # 16c. ParticleNet: its kernels at the cell's shapes, then the train
    # CLI and the evaluate CLI with the launches counted
    pn_fwd, pn_bwd = kernel_pn_edge_phase(device)
    pn_main = pn_train_phase(work)

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
        "launches": eval_launches + pred_launches + train_fwd + mesh_fwd
        + etl["fwd"],
        "library_ms": None}, **fwd), dict({
        "name": "window_max_bwd", "route": "cuda",
        "source": src + "window_max.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/edgeconv_window.py:143",
        "launches": train_bwd + mesh_bwd + etl["bwd"], "library_ms": None},
        **bwd), dict({
        "name": "window_max_fwd_bf16", "route": "cuda",
        "source": src + "window_max.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/edgeconv_window.py:82",
        "launches": bf16_eval_launches + bf16_train_fwd,
        "library_ms": None}, **fwd_bf16), dict({
        "name": "window_max_bwd_bf16", "route": "cuda",
        "source": src + "window_max.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/edgeconv_window.py:143",
        "launches": bf16_train_bwd, "library_ms": None}, **bwd_bf16), dict({
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
            "launches": runs("edge_mlp_fwd") + mesh_drn_fwd,
            "library_ms": None},
            **emlp), dict({
            "name": "edge_mlp_bwd", "route": "cuda",
            "source": src + "edge_mlp.cu",
            "replaces": "deepmetv2_tpu/ops/pallas/edge_mlp.py:121",
            "launches": drn_train["edge_mlp_bwd"] + mesh_drn_bwd,
            "library_ms": None},
            **emlp_bwd), dict({
            "name": "window_max_fwd_pipelined", "route": "cuda",
            "source": src + "window_max.cu",
            "replaces": "scripts/window_revolver_probe.py:37",
            "launches": probe_launches, "library_ms": None}, **probe), dict({
            "name": "cat_embed_fwd", "route": "cuda",
            "source": src + "cat_embed.cu", "replaces": None,
            "launches": EMBED_MAIN["cat_embed_fwd"]}, **embed_fwd), dict({
            "name": "cat_embed_bwd", "route": "cuda",
            "source": src + "cat_embed.cu", "replaces": None,
            "launches": EMBED_MAIN["cat_embed_bwd"]}, **embed_bwd), dict({
            "name": "pn_edge_fwd", "route": "cuda",
            "source": src + "pn_edge.cu", "replaces": None,
            "launches": pn_main["pn_edge_fwd"]}, **pn_fwd), dict({
            "name": "pn_edge_bwd", "route": "cuda",
            "source": src + "pn_edge.cu", "replaces": None,
            "launches": pn_main["pn_edge_bwd"]}, **pn_bwd)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
