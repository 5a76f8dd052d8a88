"""End-to-end epoch-loop throughput: the CLIs' loop, not a device
microbenchmark (port of ``dpc_tpu/train/bench_loop.py``).

``python -m dpc_tpu_torch.bench`` times the step on a device-resident
batch; this tool runs the CLIs' own ``loop.run_epoch`` (one step deep:
a step's metrics are read after the next step is queued) over a batch
source and reports clips/s, to tell the loop's cost from the feed's:

  * ``--source cached`` (default): the same pinned host batch every step,
    copied by the CLIs' ``DeviceFeed`` on its side stream — loop, copy
    and metric-drain overhead;
  * ``--source device``: a device-resident batch — the loop's host cost
    alone (``--sync`` reads every step's metrics at once, the baseline of
    the one-deep drain);
  * ``--source loader``: a ``ClipLoader`` over the synthetic set, with the
    host half of ``--device_augment`` when it is given — the feed on this
    host.

The step is the pretrain flagship of ``dpc_tpu_torch.bench`` (R18-128,
8×5, pred 3, bf16, the ConvGRU and flash-NCE kernels); with
``--device_augment`` it takes uint8 windows and runs the crop_resize
recipe on the device.  Clips are counted as run (the loss meter's count).
Runs on the card; ``--device cpu`` runs it on the CPU, and CUDA without a
card raises.

Usage:
  python -m dpc_tpu_torch.train.bench_loop --source device
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from dpc_tpu_torch import bench
from dpc_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                       resolve_device)
from dpc_tpu_torch.data.loader import ClipLoader
from dpc_tpu_torch.train import loop
from dpc_tpu_torch.train.metrics import MetricBundle
from dpc_tpu_torch.utils import profiling


class CachedLoader:
    """Yields the same batch ``n`` times (pure loop-overhead probe)."""

    def __init__(self, batch, n: int):
        self.batch = batch
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        for _ in range(self.n):
            yield self.batch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="epoch-loop clips/s")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--img_dim", default=128, type=int)
    p.add_argument("--steps", default=40, type=int)
    p.add_argument("--source", default="cached",
                   choices=["cached", "loader", "device"])
    p.add_argument("--sync", action="store_true",
                   help="read every step's metrics at once (no one-deep "
                        "drain): the baseline of the drain")
    p.add_argument("--device_augment", action="store_true")
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card fails")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg, tcfg, _, step = bench.flagship(
        device, args.batch_size, args.img_dim, args.compute_dtype,
        device_augment=args.device_augment)
    cuda = device.type == "cuda"
    feed = loop.DeviceFeed(device)
    gen = torch.Generator(device=device).manual_seed(1)  # GRU dropout
    aug_gen = torch.Generator().manual_seed(2)  # the recipe's draws
    n_dispatched = 0

    def dispatch(idx, batch):
        # count real dispatches: a small loader can yield fewer than
        # --steps batches, and clips/s over steps never run would
        # overstate throughput
        nonlocal n_dispatched
        n_dispatched += 1
        on_device = (isinstance(batch, torch.Tensor)
                     and batch.device.type == device.type)
        xb = batch if on_device else feed(batch)
        metrics = step(xb, gen, aug_gen)
        if args.sync:  # the eager-read baseline
            metrics = {k: float(v) for k, v in metrics.items()}
        return metrics

    # the batch the step takes: uint8 pre-crop windows under
    # --device_augment, for the cached and the device source alike (the
    # augmenting step on f32 noise would be a path production never runs)
    host = torch.from_numpy(bench.flagship_batch(cfg, tcfg, seed=0))
    if args.source == "device":
        loader = CachedLoader(host.to(device), args.steps + 5)
    elif args.source == "cached":
        loader = CachedLoader(host.pin_memory() if cuda else host,
                              args.steps + 5)
    else:
        from dpc_tpu_torch.train.pretrain import get_dataset

        exp = ExperimentConfig(model=cfg, train=tcfg, data=DataConfig(
            dataset="synthetic", num_workers=args.num_workers,
            synthetic_num_videos=max(256, args.batch_size * 4)))
        loader = ClipLoader(get_dataset(exp, "train"), args.batch_size,
                            num_workers=args.num_workers, pin_memory=cuda)

    try:
        # warm-up: cuDNN's algorithm choice, the kernels' first launches
        # and the loader's spin-up (2 steps)
        loop.run_epoch(dispatch, loader, MetricBundle(), print_freq=1000,
                       max_steps=2)
        profiling.synchronize(device)
        n_dispatched = 0
        meters = MetricBundle()
        t0 = time.perf_counter()
        loop.run_epoch(dispatch, loader, meters, print_freq=1000,
                       max_steps=args.steps)
        # run_epoch reads the last step's metrics before it returns; the
        # synchronize also waits for that step's Adam update
        profiling.synchronize(device)
        dt = time.perf_counter() - t0
    finally:
        if hasattr(loader, "close"):
            loader.close()
    steps = n_dispatched
    clips_done = meters["loss"].count  # rows actually processed
    result = {
        "metric": "end-to-end train clips/s (driver loop)",
        "value": round(clips_done / dt, 2),
        "unit": "clips/s",
        "source": args.source,
        "device_augment": args.device_augment,
        "steps": steps,
        "ms_per_step": round(dt / max(steps, 1) * 1e3, 2),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
