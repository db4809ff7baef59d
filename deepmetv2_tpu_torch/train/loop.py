"""Train and evaluate loops (the JAX package's ``train/loop.py``;
reference train.py:34-145, evaluate.py:31-164), on one device or, with a
``mesh`` (parallel/), on each rank of a data-parallel or edge-partitioned
mesh.

The artifact contract is the reference's: ``loss.log`` CSV,
``metrics_val_{best,last}.json``, ``{best,last}.resolutions`` (lz4 pickle),
``{best,last}.ckpt``, plus the run's ``config.json``.  As in the JAX
package, ``fit`` reads the config's feed: ``chain_steps`` consecutive
same-shape steps run as one chain (train/chain.py: one CUDA graph replay
on the card), and with ``resident_feed`` the epoch is staged on the device
once and replayed (train/resident.py); ``chain_steps: 1`` with
``resident_feed: false`` is per-step dispatch with a double-buffered copy
of each batch.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.config import Config
from deepmetv2_tpu_torch.data.batching import to_device
from deepmetv2_tpu_torch.data.loader import (PaddedLoader, device_feed,
                                             prefetch_to_device)
from deepmetv2_tpu_torch.train import metrics as metrics_mod
from deepmetv2_tpu_torch.train.chain import (chain_batches,
                                             make_chained_train_step,
                                             mesh_train_step)
from deepmetv2_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)
from deepmetv2_tpu_torch.train.family import of_model
from deepmetv2_tpu_torch.train.resident import ResidentFeed
from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
from deepmetv2_tpu_torch.train.step import (make_bn_refresh_step,
                                            make_train_step,
                                            set_learning_rate)
from deepmetv2_tpu_torch.utils import artifacts
from deepmetv2_tpu_torch.utils.logging import RunningAverage, StepTimer
from deepmetv2_tpu_torch.utils.profiling import annotate


def feed_line(cfg: Config, device, mesh=None) -> str:
    """The feed ``fit`` runs under ``cfg`` on ``device``, in one line:
    resident or streaming, the chain length, CUDA graphs or eager steps
    (always eager on a mesh)."""
    chain = max(1, cfg.train.chain_steps)
    graphs = (chain > 1 and torch.device(device).type == "cuda"
              and mesh is None)
    how = ("CUDA graphs" if graphs
           else "eager (mesh)" if mesh is not None else "eager")
    return (f"feed: {'resident' if cfg.train.resident_feed else 'streaming'}"
            f", chain {chain}, {how}")


def train_one_epoch(model, optimizer, train_step, feed, epoch: int, device,
                    log_every: int = 50, verbose: bool = True,
                    chain: int = 1, shard=None) -> float:
    """One pass over the training set (reference train.py:34-60); returns
    the mean train loss.  ``feed`` is a ``ResidentFeed`` (its stacks are
    already chained and on the device) or a host loader, whose batches are
    stacked into chains of up to ``chain`` (then ``train_step`` is a
    chained step, train/chain.py) and streamed through
    ``prefetch_to_device``, each through ``shard`` first on a mesh (this
    rank's rows).  Losses stay on the device, with one sync at each log
    line (at a chain boundary), and are stacked once at the end."""
    losses = []
    avg = RunningAverage()
    timer = StepTimer()
    timer.start()
    if isinstance(feed, ResidentFeed):
        it, total = iter(feed), feed.n_steps
    else:
        stacks = chain_batches(iter(feed), chain)
        it = prefetch_to_device(map(shard, stacks) if shard else stacks,
                                place=device)
        total = len(feed)
    done = 0
    for batch in it:
        loss = train_step(model, optimizer, batch)
        losses.append(loss)
        k = loss.shape[0] if loss.ndim else 1
        done += k
        if verbose and done // log_every > (done - k) // log_every:
            avg.update(float(loss.mean()))
            print(f"  epoch {epoch} step {done}/{total} "
                  f"loss {avg():.3f} "
                  f"({done / max(timer.elapsed, 1e-9):.2f} it/s)")
    with annotate("train.epoch_end"):
        mean_loss = (float(torch.cat([l.reshape(-1) for l in losses]).mean())
                     if losses else float("inf"))
    if verbose:   # the float() above waited for the epoch's last step
        print(f"Training epoch: {epoch:02d}, MSE: {mean_loss:.4f} "
              f"({timer.elapsed:.2f} s, "
              f"{1e3 * timer.elapsed / max(done, 1):.2f} ms/step)")
    return mean_loss


def evaluate(model, eval_step, loader: PaddedLoader, cfg: Config, device,
             verbose: bool = True, pad=None) -> Tuple[Dict[str, float], Dict]:
    """Full validation pass + qT-binned resolution summary, for either
    family's eval step (``(v_met, loss, weights or None)``).  Losses and
    per-event metrics stay on the device until the end of the pass.
    ``loader`` is a host loader (its batches copied one at a time, each
    through ``pad`` first on a mesh) or a ``ResidentFeed`` of single
    batches."""
    losses = []
    arrs, qts, evs = [], [], []
    has_deepmet = False
    feed = (iter(loader) if isinstance(loader, ResidentFeed)
            else device_feed(map(pad, loader) if pad else loader, device))
    for batch in feed:
        v_met, loss, _ = eval_step(model, batch)
        losses.append(loss)
        has_deepmet = bool(batch.y.shape[1] > 6)
        arr, qt = metrics_mod._decompose_all(v_met, batch.y, has_deepmet)
        arrs.append(arr)
        qts.append(qt)
        evs.append(batch.num_valid)
    if arrs:
        resolutions_arr, qt_arr = metrics_mod.finalize_resolutions(
            arrs, qts, evs, has_deepmet)
    else:
        resolutions_arr, qt_arr = {}, np.zeros((0,))

    hists = metrics_mod.resolution_histograms(
        resolutions_arr, qt_arr,
        max_qt=cfg.train.qt_max,
        bin_width=cfg.train.qt_bin_width,
        hist_bins=cfg.train.qt_hist_bins,
    )
    metrics_mean = {"loss": float(torch.stack(losses).mean())
                    if losses else float("inf")}
    if verbose:
        print("- Eval metrics : " +
              " ; ".join(f"{k}: {v:05.3f}" for k, v in metrics_mean.items()))
    return metrics_mean, hists


def fit(model, optimizer, cfg: Config, train_loader: PaddedLoader,
        val_loader: PaddedLoader, ckpt_dir: str, device,
        restore_file: Optional[str] = None, epochs: Optional[int] = None,
        verbose: bool = True, mesh=None, shard_nodes: bool = False) -> None:
    """The training loop (reference train.py:62-145) for each family:
    epochs of train steps, the plateau step on the mean train loss, then
    validation, checkpoints and artifacts.  The model's class picks the
    family's row (``train/family.of_model``) and so its steps, as the JAX
    package's ``model`` argument does (loop.py:260-264).  The feed is the
    config's, as in the JAX package (loop.py:211-212, 253-258, 276-282):
    chains of ``cfg.train.chain_steps`` steps, and with
    ``cfg.train.resident_feed`` the train epoch (chained) and the
    validation epoch staged on the device once.  ``restore_file`` ('best'
    or 'last') resumes model, optimizer and scheduler from a checkpoint of
    either package in ``ckpt_dir``, and the best loss from its
    ``metrics_val_best.json``.

    ``mesh`` (parallel/mesh.py, this rank's view; ``device`` its device)
    trains on a mesh, as the JAX package's ``fit`` does (loop.py:183-240):
    data parallel over the ``data`` axis, and with ``shard_nodes``
    edge-partitioned over the ``node`` axis (GraphMET: window mode,
    host-sorted batches; the DRN: node-sharded, parallel/dyn.py, its kNN
    build by ``cfg.drn.ring_knn``); each rank stages only its own rows,
    chains are loops of eager mesh steps, and evaluation is data parallel
    (parallel/dp.py:make_dp_eval_step on batches padded to a multiple of
    D).  Every rank reads the checkpoint it resumes from; only rank 0
    writes checkpoints, logs and artifacts, and only it prints.  The
    BatchNorm refresh runs the single-device forward on the whole host
    batch on every rank, as the JAX package's does."""
    primary = mesh is None or mesh.rank == 0
    verbose = verbose and primary
    if primary:
        os.makedirs(ckpt_dir, exist_ok=True)
    family = of_model(model)
    objective = family.objective(cfg)
    eval_step = family.eval_step(cfg)
    chain = max(1, cfg.train.chain_steps)
    train_shard = eval_pad = None
    if mesh is not None:
        from deepmetv2_tpu_torch.parallel.dp import (eval_padding,
                                                     make_dp_eval_step)
        from deepmetv2_tpu_torch.parallel.mesh import shard_batch

        train_step = (make_chained_train_step(cfg, family.name, mesh,
                                              shard_nodes)
                      if chain > 1 else
                      mesh_train_step(cfg, family.name, mesh, shard_nodes))
        eval_step = make_dp_eval_step(cfg, mesh, family.name)
        eval_pad = eval_padding(mesh)

        def train_shard(b):
            return shard_batch(b, mesh, shard_nodes, chained=chain > 1)
    else:
        train_step = (make_chained_train_step(cfg, family.name) if chain > 1
                      else make_train_step(cfg, objective))
    refresh_step = make_bn_refresh_step(objective)
    host_train_loader = train_loader        # the BatchNorm refresh reads it
    if cfg.train.resident_feed:
        train_loader = ResidentFeed(train_loader, chain=chain, place=device,
                                    shard=train_shard)
        val_loader = ResidentFeed(val_loader, chain=1, place=device,
                                  shard=eval_pad)
    scheduler = ReduceLROnPlateau(
        lr=cfg.optim.lr,
        factor=cfg.optim.plateau_factor,
        patience=cfg.optim.plateau_patience,
        threshold=cfg.optim.plateau_threshold,
    )

    first_epoch = 0
    best_validation_loss = 1e8  # reference train.py:78
    if restore_file is not None:
        payload = restore_checkpoint(
            osp.join(ckpt_dir, restore_file + ".ckpt"), model, optimizer,
            scheduler)
        first_epoch = payload["epoch"]
        if verbose:
            print(f"Restarting training from epoch {first_epoch}")
        best_json = osp.join(ckpt_dir, "metrics_val_best.json")
        if osp.exists(best_json):
            with open(best_json) as f:
                best_validation_loss = json.load(f)["loss"]

    if primary:
        with open(osp.join(ckpt_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    loss_log = (open(osp.join(ckpt_dir, "loss.log"),
                     "a" if restore_file else "w")
                if primary else open(os.devnull, "w"))
    if not restore_file:
        loss_log.write("# loss log for training starting at "
                       + time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime())
                       + "\n")
        loss_log.write("epoch, loss, val_loss\n")
        loss_log.flush()

    n_epochs = epochs if epochs is not None else cfg.train.epochs
    t_fit = time.perf_counter()
    for epoch in range(first_epoch + 1, n_epochs + 1):
        if verbose:
            print(f"Current best loss: {best_validation_loss}")
            print(f"Learning rate: {scheduler.lr}")

        train_loss = train_one_epoch(model, optimizer, train_step,
                                     train_loader, epoch, device,
                                     verbose=verbose, chain=chain,
                                     shard=train_shard)

        if cfg.train.bn_refresh_batches > 0:
            # precise-BN: re-estimate the running statistics under the
            # CURRENT parameters before validating
            for i, rb in enumerate(host_train_loader):
                if i >= cfg.train.bn_refresh_batches:
                    break
                refresh_step(model, to_device(rb, device))
        set_learning_rate(optimizer, scheduler.step(train_loss))  # train.py:58

        if primary:
            save_checkpoint(model, optimizer, scheduler, epoch,
                            is_best=False, checkpoint_dir=ckpt_dir)

        test_metrics, resolutions = evaluate(model, eval_step, val_loader,
                                             cfg, device, verbose=verbose,
                                             pad=eval_pad)
        validation_loss = test_metrics["loss"]
        loss_log.write(f"{epoch},{train_loss:.2f},{validation_loss:.2f}\n")
        loss_log.flush()

        if validation_loss <= best_validation_loss:
            if verbose:
                print("Found new best loss!")
            best_validation_loss = validation_loss
            if primary:
                save_checkpoint(model, optimizer, scheduler, epoch,
                                is_best=True, checkpoint_dir=ckpt_dir)
                artifacts.save_dict_to_json(
                    test_metrics, osp.join(ckpt_dir, "metrics_val_best.json"))
                artifacts.save(resolutions,
                               osp.join(ckpt_dir, "best.resolutions"))

        if primary:
            artifacts.save_dict_to_json(
                test_metrics, osp.join(ckpt_dir, "metrics_val_last.json"))
            artifacts.save(resolutions,
                           osp.join(ckpt_dir, "last.resolutions"))

    loss_log.close()
    if verbose:
        print(f"Trained epochs {first_epoch + 1}..{n_epochs} in "
              f"{time.perf_counter() - t_fit:.1f} s")
