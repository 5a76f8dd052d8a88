"""DPC self-supervised pretraining CLI (port of
``dpc_tpu/train/pretrain.py``).

Keeps the JAX CLI's flags and printed lines for what it runs, and adds
``--device`` (default ``cuda``).  One device, local negatives: the ucf101,
hmdb51 and k400 frame trees (or the synthetic dataset), a validation epoch
after each train epoch, epoch checkpoints in the reference's ``.pth.tar``
layout with the best by val top-1, ``--resume`` and ``--reset_lr``,
``--save_every_steps`` with exact-batch mid-epoch resume, a SIGTERM/SIGINT
guard that checkpoints and exits (also during validation), ``--pretrain``,
a retry with activation checkpointing (``--remat``) when the first step
runs out of device memory, and ``--device_augment``: the host half decodes
uint8 windows (the scale and crop inside the JPEG decode), the recipe runs
on the device inside the steps, and ``--fold_normalize`` may fold its
normalize into the stem conv.  Tensorboard scalars and the input grid
go under the run directory where ``tensorboardX`` imports;
``--debug_nans`` turns on autograd's anomaly mode and a finite-loss check
in every step; ``--profile`` profiles the second train epoch.  The dropout
and augmentation draws and the loader's order are derived from (seed,
epoch, batch), so a resumed run computes what the uninterrupted run did.
Several devices run one rank each (``parallel/mesh.py``, started by
``train/ranks.py`` as for the finetune CLI): ``--num_devices
N`` starts N ranks from this process (0: every visible card, one rank on
the CPU), NCCL on the cards and gloo with ``--device cpu``; under torchrun
(or with ``--multihost``, which reads torchrun's environment) each
process is one rank.  Each rank loads its own ``batch_size // ranks``
clips from its shard of the dataset, as ``dpc_tpu``'s ``--multihost``
processes do, and the steps average the gradients and metrics over the
ranks (``--negatives``, ``--model_parallel`` and ``--cross_replica_bn``
as in ``dpc_tpu``).  Rank 0 prints the lines and writes the checkpoints;
every rank reads them on resume; a signal to one rank stops every rank at
the same step; a rank that fails fails the run.  More ranks than cards is
refused.

Usage:
  python -m dpc_tpu_torch.train.pretrain --dataset synthetic --epochs 1 \
      --steps_per_epoch 2 --batch_size 8 --nce_impl fused
  python -m dpc_tpu_torch.train.pretrain --dataset ucf101 --data_root DIR \
      --batch_size 64 --epochs 300 --save_every_steps 500 --device_augment
  python -m dpc_tpu_torch.train.pretrain --num_devices 4 --model_parallel 2 \
      --negatives global --batch_size 64 ...
  torchrun --nproc_per_node 8 -m dpc_tpu_torch.train.pretrain --multihost \
      --negatives global --batch_size 256 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from dpc_tpu_torch.core import checkpoint as ckpt
from dpc_tpu_torch.core.config import (DataConfig, DPCConfig,
                                       ExperimentConfig, TrainConfig,
                                       experiment_name, resolve_device)
from dpc_tpu_torch.data import augment
from dpc_tpu_torch.data.device_augment import device_augment_geometry
from dpc_tpu_torch.data.loader import ClipLoader
from dpc_tpu_torch.data.synthetic import SyntheticVideoDataset
from dpc_tpu_torch.data.video_dataset import make_dataset
from dpc_tpu_torch.models import dpc as dpc_model
from dpc_tpu_torch.parallel import collectives
from dpc_tpu_torch.parallel import mesh as meshlib
from dpc_tpu_torch.train import loop, optim, pretrain_step, ranks
from dpc_tpu_torch.train.metrics import MetricBundle
from dpc_tpu_torch.utils import profiling


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DPC pretraining (PyTorch/CUDA)")
    # reference flag set (dpc/main.py:27-47)
    p.add_argument("--net", default="resnet18")
    p.add_argument("--model", default="dpc-rnn", choices=["dpc-rnn"])
    p.add_argument("--dataset", default="ucf101",
                   choices=["ucf101", "hmdb51", "k400", "synthetic"])
    p.add_argument("--seq_len", default=5, type=int)
    p.add_argument("--num_seq", default=8, type=int)
    p.add_argument("--pred_step", default=3, type=int)
    p.add_argument("--ds", default=3, type=int,
                   help="frame downsample rate (k400 forces 5)")
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--wd", default=1e-5, type=float)
    p.add_argument("--resume", default="")
    p.add_argument("--pretrain", default="")
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--print_freq", default=5, type=int)
    p.add_argument("--reset_lr", action="store_true")
    p.add_argument("--prefix", default="tmp")
    p.add_argument("--train_what", default="all", choices=["all", "last"])
    p.add_argument("--img_dim", default=128, type=int)
    # additions of dpc_tpu
    p.add_argument("--data_root", default="")
    p.add_argument("--nce_impl", default="auto",
                   choices=["auto", "xla", "fused"],
                   help="NCE loss path: auto picks by projected score bytes "
                        "(materialised score when it fits the device, flash "
                        "kernels otherwise)")
    p.add_argument("--negatives", default="local",
                   choices=["local", "global"])
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--num_devices", default=0, type=int)
    p.add_argument("--model_parallel", default=1, type=int)
    p.add_argument("--cross_replica_bn", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of a torchrun job: join its process group "
                        "(RANK, WORLD_SIZE, MASTER_ADDR...) and read this "
                        "rank's shard of the data")
    p.add_argument("--device_augment", action="store_true",
                   help="host workers decode uint8 windows only; the crop, "
                        "flip, gray, jitter and normalize run on the device")
    p.add_argument("--fold_normalize", default="auto",
                   choices=["auto", "on", "off"],
                   help="fold the --device_augment normalize into the stem "
                        "conv; auto: off for the pretrain recipes")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--prefetch", default=4, type=int)
    p.add_argument("--worker_mode", default="thread",
                   choices=["thread", "process"])
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--synthetic_videos", default=32, type=int)
    p.add_argument("--unit_test", action="store_true",
                   help="32-video subsample for smoke runs")
    p.add_argument("--steps_per_epoch", default=0, type=int,
                   help="cap train and val steps per epoch (0 = full epoch)")
    p.add_argument("--save_every_steps", default=0, type=int,
                   help="mid-epoch checkpoint interval (0 = per-epoch "
                        "only); resume continues from the exact batch")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler table of the run's second "
                        "train epoch to this file, and a Chrome trace beside "
                        "it, and print its clips/s and the device's busy "
                        "share")
    p.add_argument("--debug_nans", action="store_true",
                   help="anomaly mode: raise on the first NaN or Inf in the "
                        "loss or in a backward function (slow)")
    # addition of dpc_tpu_torch
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card fails")
    return p


def config_from_args(args) -> ExperimentConfig:
    downsample = 5 if args.dataset == "k400" else args.ds  # dpc/main.py:293
    return ExperimentConfig(
        model=DPCConfig(img_dim=args.img_dim, num_seq=args.num_seq,
                        seq_len=args.seq_len, pred_step=args.pred_step,
                        network=args.net, compute_dtype=args.compute_dtype),
        data=DataConfig(dataset=args.dataset, data_root=args.data_root,
                        synthetic_num_videos=args.synthetic_videos,
                        downsample=downsample, num_workers=args.num_workers,
                        worker_mode=args.worker_mode, prefetch=args.prefetch),
        train=TrainConfig(batch_size=args.batch_size, lr=args.lr, wd=args.wd,
                          epochs=args.epochs, start_epoch=args.start_epoch,
                          print_freq=args.print_freq,
                          train_what=args.train_what, prefix=args.prefix,
                          resume=args.resume, pretrain=args.pretrain,
                          reset_lr=args.reset_lr, seed=args.seed,
                          num_devices=args.num_devices,
                          model_parallel=args.model_parallel,
                          negatives=args.negatives, nce_impl=args.nce_impl,
                          cross_replica_bn=args.cross_replica_bn,
                          device_augment=args.device_augment,
                          fold_normalize=args.fold_normalize,
                          device_augment_recipe=(
                              "sized_crop" if args.dataset == "k400"
                              else "crop_resize"),
                          remat=args.remat),
    )


def get_dataset(cfg: ExperimentConfig, mode: str, unit_test: bool = False):
    """The ``mode`` split with the pretrain recipe: the synthetic videos
    with a random sized crop, or a frame tree with the reference's recipe
    for its dataset (``augment.pretrain_transform``).  With
    ``device_augment`` only the host half: ``HostScaleCrop`` to the window
    of ``device_augment_geometry`` (UCF/HMDB the consistent 224 crop of the
    240 short side, K400 a native-geometry window), which a frame tree runs
    inside the JPEG decode; the recipe runs in the steps."""
    m, d = cfg.model, cfg.data
    big = d.dataset == "k400" and m.img_dim > 140  # dpc/main.py:288
    if cfg.train.device_augment:
        short, win = device_augment_geometry(d.dataset, m.img_dim)
        host = augment.HostScaleCrop(short, win)
        if d.dataset == "synthetic":
            return SyntheticVideoDataset(
                transform=host, num_videos=d.synthetic_num_videos,
                video_len=d.synthetic_video_len,
                frame_size=max(m.img_dim, 130), num_seq=m.num_seq,
                seq_len=m.seq_len, downsample=d.downsample, mode=mode,
                seed=1 if mode == "val" else 0)
        return make_dataset(d.dataset, d.data_root, mode, host,
                            num_seq=m.num_seq, seq_len=m.seq_len,
                            downsample=d.downsample, big=big,
                            unit_test=unit_test,
                            val_subsample=d.val_subsample)
    if d.dataset == "synthetic":
        return SyntheticVideoDataset(
            transform=augment.Compose([
                augment.RandomSizedCrop(size=m.img_dim, p=1.0),
                augment.Normalize()]),
            num_videos=d.synthetic_num_videos,
            video_len=d.synthetic_video_len,
            frame_size=max(m.img_dim, 130), num_seq=m.num_seq,
            seq_len=m.seq_len, downsample=d.downsample, mode=mode,
            seed=1 if mode == "val" else 0)
    return make_dataset(d.dataset, d.data_root, mode,
                        augment.pretrain_transform(d.dataset, m.img_dim),
                        num_seq=m.num_seq, seq_len=m.seq_len,
                        downsample=d.downsample, big=big,
                        unit_test=unit_test, val_subsample=d.val_subsample)


def write_profile(path: str, prof, steps: int, batch_size: int,
                  wall_ms: float) -> None:
    """Write a profile's table to ``path`` and the device time of every
    kernel name (ms over the window) to ``path + '.json'``, and print the
    window's train clips/s and the device's busy share (``profiling.
    device_busy``; the waits for the loader count as idle, the JPEG
    codec's kernels as busy where they run on the same card)."""
    busy_ms, busy_pct = profiling.device_busy(prof, wall_ms)
    summary = (f"{steps} train steps: wall {wall_ms:.1f} ms, "
               f"{1e3 * steps * batch_size / wall_ms:.2f} clips/s, "
               f"device busy {busy_ms:.1f} ms ({busy_pct:.1f}%)")
    with open(path, "a") as f:
        f.write(summary + "\n" + prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=40) + "\n")
    with open(path + ".json", "w") as f:
        json.dump({"steps": steps, "wall_ms": wall_ms, "kernels_ms": {
            e.key: e.self_device_time_total / 1e3
            for e in profiling.device_events(prof)}}, f)
    print(f"[profile] {summary}; table in {path}", flush=True)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    t = config_from_args(args).train
    ranks.run(main, argv, args, device,
              lambda n_data, n_model: pretrain_step.check_layout(
                  t, n_data, n_model),
              lambda world: _run(args, device, world))


def _run(args, device: torch.device, world: int) -> None:
    cfg = config_from_args(args)
    m, t = cfg.model, cfg.train
    mesh, device = ranks.mesh_and_device(device, world, t.model_parallel)
    # gru_impl has no flag: the CLI runs the recurrence kernel, as the
    # library path does when its config asks for it
    m = dataclasses.replace(m, gru_impl="pallas")
    cfg = dataclasses.replace(cfg, model=m)
    print(f"devices: {mesh.shape} × {device.type}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + f"; negatives={t.negatives}; dtype={m.compute_dtype}")
    if mesh.size == 1:
        mesh = None
    rank0 = mesh is None or mesh.rank == 0

    exp_dir = (args.resume if args.resume
               else os.path.join(args.log_dir,
                                 f"{args.prefix}_{experiment_name(cfg)}"))
    if rank0:
        os.makedirs(exp_dir, exist_ok=True)
        with open(os.path.join(exp_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    model = dpc_model.build_dpc(m, device, seed=t.seed)
    opt = optim.pretrain_optimizer(model, t.lr, t.wd, t.train_what)
    if t.pretrain:
        ckpt.load_pretrained(t.pretrain, model, verbose=rank0)

    def restore(payload: dict) -> None:
        """Parameters, and the optimizer unless --reset_lr asks for a
        fresh one."""
        model.load_state_dict(payload["state_dict"])
        if not t.reset_lr:
            opt.load_state_dict(payload["optimizer"])

    mgr = ckpt.CheckpointManager(os.path.join(exp_dir, "model"))
    start_epoch, best_acc, iteration = t.start_epoch, 0.0, 0
    if args.resume:
        epoch0, payload = ckpt.restore_latest(mgr)
        if epoch0 is not None:
            restore(payload)
            best_acc = float(payload["best_acc"])
            iteration = int(payload["iteration"])
            start_epoch = epoch0
            print(f"resumed epoch {epoch0} (best_acc {best_acc:.4f})")
        else:
            # train from scratch into the resume dir, like the reference
            # (dpc/main.py:102), but never silently
            print(f"[Warning] no checkpoint found at '{args.resume}'")

    # mid-epoch checkpoints: preemption recovery finer than an epoch
    step_mgr = (ckpt.CheckpointManager(os.path.join(exp_dir, "model_steps"),
                                       keep_best=False, step_files=True)
                if args.save_every_steps else None)
    start_batch = 0
    if args.resume and step_mgr is not None:
        payload, start_epoch, start_batch = ckpt.resume_mid_epoch(
            step_mgr, start_epoch)
        if payload is not None:
            restore(payload)
            best_acc = float(payload["best_acc"])
            iteration = int(payload["iteration"])
            print(f"resumed mid-epoch: epoch {start_epoch} "
                  f"batch {start_batch}")

    # every rank starts from rank 0's parameters
    collectives.broadcast_(list(model.parameters()) + list(model.buffers()),
                           mesh and mesh.world_group)
    step = loop.RematRetry(
        lambda remat: pretrain_step.make_pretrain_step(
            m, dataclasses.replace(t, remat=remat), model, opt, mesh),
        model, opt, t.remat, retry=mesh is None)
    eval_step = pretrain_step.make_eval_step(m, t, model, mesh)
    gen = torch.Generator(device=device)
    aug_gen = torch.Generator()  # the device recipe's draws, made on the host
    augmenting = t.device_augment
    to_device = loop.DeviceFeed(device)

    def loader(mode: str, seed: int) -> ClipLoader:
        # each rank reads its shard, batch_size // ranks clips a batch
        return ClipLoader(get_dataset(cfg, mode, args.unit_test),
                          t.batch_size // world,
                          num_workers=cfg.data.num_workers,
                          worker_mode=cfg.data.worker_mode,
                          prefetch_batches=cfg.data.prefetch, seed=seed,
                          pin_memory=device.type == "cuda",
                          shard_id=mesh.rank if mesh else 0,
                          num_shards=world)

    train_loader, val_loader = loader("train", t.seed), loader("val",
                                                               t.seed + 1)
    print(f"train videos: {len(train_loader.dataset)}; "
          f"val videos: {len(val_loader.dataset)}")
    writer_train, writer_val = (loop.open_tensorboard(exp_dir) if rank0
                                else (None, None))

    def save_mid_epoch(ep: int, batch_idx: int) -> None:
        sid = ckpt.mid_epoch_step_id(ep, batch_idx, offset=iteration)
        ckpt.write_on_rank0(lambda: ckpt.save_step_unless_duplicate(
            step_mgr, sid,
            lambda: {"epoch": ep, "batch_idx": batch_idx, "net": m.network,
                     "state_dict": model.state_dict(),
                     "optimizer": opt.state_dict(), "best_acc": best_acc,
                     "iteration": iteration}), mesh)

    guard = (loop.PreemptionGuard(mesh and mesh.host_group).install()
             if step_mgr else None)
    if args.debug_nans:
        profiling.enable_debug(nan_checks=True)
    try:
        for epoch in range(start_epoch, t.epochs):
            train_loader.set_epoch(epoch)
            val_loader.set_epoch(epoch)

            def train_dispatch(idx, batch, epoch=epoch):
                def reseed():
                    # per rank: data shards draw distinct streams, model
                    # peers one augmentation stream and their own dropout
                    gen.manual_seed(meshlib.dropout_seed(
                        mesh, loop.step_seed(t.seed, epoch, idx)))
                    if augmenting:
                        aug_gen.manual_seed(meshlib.data_seed(
                            mesh, loop.step_seed(t.seed, epoch, idx,
                                                 loop.TRAIN_AUGMENT)))

                reseed()
                return step(reseed, to_device(batch), gen, aug_gen)

            def val_dispatch(idx, batch, epoch=epoch):
                if augmenting:
                    aug_gen.manual_seed(meshlib.data_seed(
                        mesh, loop.step_seed(t.seed, epoch, idx,
                                             loop.VAL_AUGMENT)))
                return eval_step(to_device(batch), aug_gen)

            def count_iteration(idx, metrics):
                nonlocal iteration
                if writer_train is not None:
                    writer_train.add_scalar("local/loss", metrics["loss"],
                                            iteration)
                    writer_train.add_scalar("local/accuracy",
                                            metrics["top1"], iteration)
                iteration += 1

            def log_input_grid(batch, epoch=epoch):
                # once a run, from the batch already in hand
                # (dpc/main.py:200-206)
                writer_train.add_images("input_seq",
                                        loop.input_grid(batch[0]),
                                        epoch, dataformats="NHWC")

            # a preemption during val persists the finished train epoch:
            # resume then skips the train batches and lands in val
            n_train = len(train_loader)
            train_done = (min(n_train, args.steps_per_epoch)
                          if args.steps_per_epoch else n_train)

            def save_from_val(ep, _val_idx):
                save_mid_epoch(ep, train_done - 1)

            # the run's second train epoch: every step after its first
            profiled = (bool(args.profile) and rank0
                        and epoch == start_epoch + 1)
            meters, vmeters = MetricBundle(), MetricBundle()
            with profiling.trace(os.path.dirname(os.path.abspath(
                    args.profile)) if profiled else None) as prof:
                t0 = time.perf_counter()
                n = loop.run_epoch(
                    train_dispatch, train_loader, meters, mode="train",
                    print_freq=t.print_freq, epoch=epoch,
                    print_fn=count_iteration,
                    max_steps=args.steps_per_epoch,
                    start_batch=start_batch if epoch == start_epoch else 0,
                    step_save_fn=save_mid_epoch if step_mgr else None,
                    save_every_steps=args.save_every_steps, guard=guard,
                    first_batch_fn=(log_input_grid if writer_train is not None
                                    and epoch == start_epoch else None))
                if prof is not None:
                    profiling.synchronize(device)
                dt = time.perf_counter() - t0
            if prof is not None:
                write_profile(args.profile, prof, n, t.batch_size, 1e3 * dt)
            nv = loop.run_epoch(
                val_dispatch, val_loader, vmeters, mode="val",
                print_freq=t.print_freq, epoch=epoch,
                max_steps=args.steps_per_epoch,
                step_save_fn=save_from_val if step_mgr else None,
                guard=guard, train=False)
            # the reference's epoch summary: the unweighted mean of the last
            # 5 steps (dpc/main.py:246), which also picks the best
            tr, va = meters.local_averages(), vmeters.local_averages()
            print(f"epoch {epoch}: train loss {tr.get('loss', 0):.4f} "
                  f"top1 {tr.get('top1', 0):.4f} | val loss "
                  f"{va.get('loss', 0):.4f} top1 {va.get('top1', 0):.4f}")
            print(f"[epoch {epoch}] {n} train steps in {dt:.1f} s, {nv} val "
                  "steps", flush=True)
            if writer_train is not None:
                for k, v in tr.items():
                    writer_train.add_scalar(f"global/{k}", v, epoch)
                for k, v in va.items():
                    writer_val.add_scalar(f"global/{k}", v, epoch)
            val_acc = va.get("top1", 0.0)
            best_acc = max(best_acc, val_acc)
            ckpt.write_on_rank0(lambda: mgr.save(
                epoch + 1,
                {"epoch": epoch + 1, "net": m.network,
                 "state_dict": model.state_dict(),
                 "optimizer": opt.state_dict(), "best_acc": best_acc,
                 "iteration": iteration},
                val_acc=val_acc), mesh)
    finally:
        train_loader.close()
        val_loader.close()
        loop.close_tensorboard(writer_train, writer_val)
        if args.debug_nans:
            profiling.disable_debug()
        if guard is not None:
            guard.uninstall()
    loop.report_fallbacks(train_loader.dataset, val_loader.dataset)
    print(f"Training from ep {start_epoch} to ep {t.epochs} finished")


if __name__ == "__main__":
    main()
