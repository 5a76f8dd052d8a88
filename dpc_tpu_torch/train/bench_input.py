"""Input-pipeline throughput benchmark, host side (port of
``dpc_tpu/train/bench_input.py``).

The reference's bottleneck crutch is 32 DataLoader worker processes each
decoding 40 JPEGs and running the PIL transform chain per sample.  This
tool measures the port's host feed (``ClipLoader`` over a dataset and its
recipe, batches pinned for the card as the CLIs make them) in clips/sec,
so the host-vs-card balance is visible:

  python -m dpc_tpu_torch.train.bench_input --dataset synthetic
  python -m dpc_tpu_torch.train.bench_input --dataset ucf101 --data_root DIR
  python -m dpc_tpu_torch.train.bench_input --dataset ucf101 \
      --data_root DIR --decode_only          # the --device_augment host half

Batches are pinned for the card unless ``--device cpu``; CUDA without a
card raises.
"""

from __future__ import annotations

import argparse
import json
import time

from dpc_tpu_torch.core.config import resolve_device


def loader_rate(loader, batches: int) -> float:
    """clips/s of ``loader`` over ``batches`` batches after one that warms
    the worker pool.  When the loader's epoch ends, its iterator is
    restarted with the clock paused: re-warming the pool on a small tree
    is not steady-state input cost (measured a 5-10x understatement on a
    24-video tree otherwise), so the batch fetched right after a restart
    absorbs the spin-up and is neither counted nor timed."""
    it = iter(loader)
    t0, dt = time.perf_counter(), 0.0

    def nxt():
        nonlocal it, t0, dt
        try:
            return next(it), True
        except StopIteration:
            dt += time.perf_counter() - t0
            it = iter(loader)
            try:
                batch = next(it)  # re-warm batch, untimed
            except StopIteration:
                raise SystemExit(
                    "loader yields zero batches (batch_size larger than "
                    "the dataset with drop_last); shrink --batch_size or "
                    "grow the tree")
            t0 = time.perf_counter()
            return batch, False

    nxt()  # warm the pool
    t0, dt, n = time.perf_counter(), 0.0, 0
    for _ in range(batches):
        batch, timed = nxt()
        if not timed:
            continue  # pool re-warm batch: excluded from clips AND clock
        n += (batch[0] if isinstance(batch, tuple) else batch).shape[0]
    dt += time.perf_counter() - t0
    if n == 0 or dt <= 0:
        raise SystemExit(
            "no steady-state batches measured: every epoch ended at one "
            "batch, so all fetches were pool re-warms; shrink "
            "--batch_size or grow the tree")
    return n / dt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="host feed clips/s")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_root", default="")
    p.add_argument("--img_dim", default=128, type=int)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--worker_mode", default="thread",
                   choices=["thread", "process"])
    p.add_argument("--decode_only", action="store_true",
                   help="decode+scale+crop only (the --device_augment host "
                        "half); default runs the full host recipe")
    p.add_argument("--no_roi", action="store_true",
                   help="with --decode_only: full decode + numpy slicing "
                        "instead of the ROI decode (A/B baseline)")
    p.add_argument("--num_seq", default=8, type=int)
    p.add_argument("--seq_len", default=5, type=int)
    p.add_argument("--task", default="pretrain",
                   choices=["pretrain", "finetune", "test", "test_five"],
                   help="with --decode_only: which CLI's host window "
                        "to decode to (finetune/test_five = "
                        "full-geometry window, test = the center 224² "
                        "the dense test keeps)")
    p.add_argument("--batches", default=8, type=int)
    p.add_argument("--device", default="cuda",
                   help="the card the batches are pinned for (default "
                        "cuda), or cpu; cuda without a card fails")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    from dpc_tpu_torch.data import augment
    from dpc_tpu_torch.data.loader import ClipLoader

    if args.decode_only:
        # the --device_augment host half: short-side scale + window, run
        # inside the JPEG decode on a frame tree (augment.HostScaleCrop;
        # --no_roi takes the full-decode + numpy path for A/B)
        from dpc_tpu_torch.data.device_augment import device_augment_geometry

        short, win = device_augment_geometry(args.dataset, args.img_dim,
                                             task=args.task)
        center = args.task.startswith("test")
        transform = augment.HostScaleCrop(short, win, center=center)
        if args.no_roi:
            transform = augment.Compose([
                augment.Scale(short), augment.PadTo(*win),
                augment.CenterCrop(win) if center else
                augment.RandomCrop(win, consistent=True)])
    else:
        transform = augment.pretrain_transform(
            "k400" if args.dataset == "synthetic" else args.dataset,
            args.img_dim)

    if args.dataset == "synthetic":
        from dpc_tpu_torch.data.synthetic import SyntheticVideoDataset

        ds = SyntheticVideoDataset(
            transform=transform,
            # +1 batch: the warm-up batch consumes one
            num_videos=max(256, args.batch_size * (args.batches + 1)),
            video_len=256, frame_size=150, num_seq=args.num_seq,
            seq_len=args.seq_len)
    else:
        from dpc_tpu_torch.data.video_dataset import make_dataset

        ds = make_dataset(args.dataset, args.data_root, "train", transform,
                          num_seq=args.num_seq, seq_len=args.seq_len,
                          big=args.dataset == "k400" and args.img_dim > 140)

    loader = ClipLoader(ds, args.batch_size, num_workers=args.num_workers,
                        worker_mode=args.worker_mode,
                        pin_memory=device.type == "cuda")
    try:
        rate = loader_rate(loader, args.batches)
    finally:
        loader.close()
    result = {
        "metric": "input clips/sec (host)",
        "value": round(rate, 2),
        "unit": "clips/s",
        "workers": args.num_workers,
        "worker_mode": args.worker_mode,
        "decode_only": args.decode_only,
        "roi_decode": args.decode_only and not args.no_roi,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
