"""DPC self-supervised pretraining CLI (port of
``dpc_tpu/train/pretrain.py``).

Keeps the JAX CLI's flag names for what it runs, and adds ``--device``
(default ``cuda``).  This slice runs the synthetic dataset on one device
with local negatives, prints the per-epoch train loss and top-1, and
writes ``config.json`` into the run directory.  Frame datasets,
validation, checkpoints and resume are ROADMAP queue 1 items 9-10; a flag
that needs them raises a clear error.

Usage:
  python -m dpc_tpu_torch.train.pretrain --dataset synthetic --epochs 1 \
      --steps_per_epoch 2 --batch_size 8 --nce_impl fused
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from dpc_tpu_torch.core.config import (DataConfig, DPCConfig,
                                       ExperimentConfig, TrainConfig,
                                       experiment_name, resolve_device)
from dpc_tpu_torch.data import augment
from dpc_tpu_torch.data.loader import ClipLoader
from dpc_tpu_torch.data.synthetic import SyntheticVideoDataset
from dpc_tpu_torch.models import dpc as dpc_model
from dpc_tpu_torch.train import optim, pretrain_step


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
    p.add_argument("--device_augment", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--prefetch", default=4, type=int)
    p.add_argument("--worker_mode", default="thread",
                   choices=["thread", "process"])
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--synthetic_videos", default=32, type=int)
    p.add_argument("--steps_per_epoch", default=0, type=int,
                   help="cap steps per epoch (0 = full epoch)")
    p.add_argument("--save_every_steps", default=0, type=int)
    p.add_argument("--log_dir", default="log")
    # addition of dpc_tpu_torch
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card fails")
    return p


def _reject_unsupported(args) -> None:
    later = {
        "--dataset": (args.dataset != "synthetic",
                      "queue 1 item 10 (frame datasets)"),
        "--resume": (bool(args.resume), "queue 1 item 10 (checkpoints)"),
        "--pretrain": (bool(args.pretrain),
                       "queue 1 item 14 (interchange)"),
        "--reset_lr": (args.reset_lr, "queue 1 item 10 (checkpoints)"),
        "--save_every_steps": (args.save_every_steps > 0,
                               "queue 1 item 10 (checkpoints)"),
        "--num_devices": (args.num_devices > 1,
                          "queue 1 item 13 (multi-GPU)"),
    }
    for flag, (bad, item) in later.items():
        if bad:
            raise SystemExit(f"{flag} is not ported to dpc_tpu_torch yet "
                             f"(ROADMAP.md {item})")


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
                          seed=args.seed, num_devices=args.num_devices,
                          model_parallel=args.model_parallel,
                          negatives=args.negatives, nce_impl=args.nce_impl,
                          cross_replica_bn=args.cross_replica_bn,
                          device_augment=args.device_augment,
                          remat=args.remat),
    )


def synthetic_dataset(cfg: ExperimentConfig, mode: str):
    m, d = cfg.model, cfg.data
    return SyntheticVideoDataset(
        transform=augment.Compose([
            augment.RandomSizedCrop(size=m.img_dim, p=1.0),
            augment.Normalize()]),
        num_videos=d.synthetic_num_videos, video_len=d.synthetic_video_len,
        frame_size=max(m.img_dim, 130), num_seq=m.num_seq,
        seq_len=m.seq_len, downsample=d.downsample, mode=mode,
        seed=1 if mode == "val" else 0)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _reject_unsupported(args)
    cfg = config_from_args(args)
    m, t = cfg.model, cfg.train
    device = resolve_device(args.device)
    # gru_impl has no flag: the CLI runs the recurrence kernel, as the
    # library path does when its config asks for it
    m = dataclasses.replace(m, gru_impl="pallas")
    cfg = dataclasses.replace(cfg, model=m)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + f"; negatives={t.negatives}; dtype={m.compute_dtype}")

    exp_dir = os.path.join(args.log_dir,
                           f"{args.prefix}_{experiment_name(cfg)}")
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    model = dpc_model.build_dpc(m, device, seed=t.seed)
    opt = optim.pretrain_optimizer(model, t.lr, t.wd, t.train_what)
    step = pretrain_step.make_pretrain_step(m, t, model, opt)
    gen = torch.Generator(device=device)
    gen.manual_seed(t.seed)

    loader = ClipLoader(synthetic_dataset(cfg, "train"), t.batch_size,
                        num_workers=cfg.data.num_workers,
                        worker_mode=cfg.data.worker_mode,
                        prefetch_batches=cfg.data.prefetch, seed=t.seed)
    print(f"train videos: {len(loader.dataset)}")
    try:
        for epoch in range(t.start_epoch, t.epochs):
            loader.set_epoch(epoch)
            sums: dict[str, float] = {}
            n = 0
            t0 = time.perf_counter()
            for idx, batch in enumerate(loader):
                if args.steps_per_epoch and idx >= args.steps_per_epoch:
                    break
                x = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
                metrics = {k: float(v) for k, v in step(x, gen).items()}
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v
                n += 1
                if idx % t.print_freq == 0:
                    print(f"epoch {epoch} step {idx}: loss "
                          f"{metrics['loss']:.4f} top1 {metrics['top1']:.4f}")
            avg = {k: v / max(n, 1) for k, v in sums.items()}
            print(f"epoch {epoch}: train loss {avg.get('loss', 0.0):.4f} "
                  f"top1 {avg.get('top1', 0.0):.4f} ({n} steps, "
                  f"{time.perf_counter() - t0:.1f} s)")
    finally:
        loader.close()
    print(f"Training from ep {t.start_epoch} to ep {t.epochs} finished")


if __name__ == "__main__":
    main()
