"""Downstream evaluation CLI: LC finetune / linear probe / dense test (port
of ``dpc_tpu/train/evaluate.py``).

Keeps the JAX CLI's flags and printed lines for what it runs and adds
``--device`` (default ``cuda``).  One device, on the ucf101 and hmdb51
frame trees or the synthetic dataset: the finetune epochs with the
multi-step-restart LR schedule and a validation epoch each, epoch
checkpoints in the reference's ``.pth.tar`` layout with the best by val
top-1, ``--resume``, ``--reset_lr``, ``--save_every_steps`` with
exact-batch mid-epoch resume and the preemption guard, ``--pretrain`` from
a pretrain run or a reference ``.pth.tar`` (transfer-loaded by
state_dict name), the ``--remat`` retry when the first step runs out of
device memory, and ``--test <run dir | .pth.tar | random>``, the dense
test of ``run_test`` (every video cut into windows, windows pooled into a
fixed ``--window_batch``, softmax averaged per video, top-1/top-5, the
confusion matrix), with ``--five_crop`` (four corners and the centre, the
crops riding the window axis), ``--test_keep_short`` and ``--unit_test``.
``--device_augment`` moves the recipes to the device: the host half
decodes uint8 windows (the scale and crop inside the JPEG decode), the
finetune and val recipes run in the steps and the test recipe in the test
forward, whose normalize ``--fold_normalize`` auto folds into the stem
conv.  The finetune writes tensorboard scalars and the input grid under
the run directory where ``tensorboardX`` imports.  Several devices run one
rank each, started as the pretrain CLI starts them (``train/ranks.py``:
``--num_devices N``, or torchrun with ``--multihost``): each rank loads
``batch_size // ranks`` clips of its shard, the steps average the
gradients, metrics and BN running statistics over the ranks
(``--model_parallel`` shards the clips over a model axis whose BN spans
the model group), rank 0 prints the lines and writes the checkpoints and
tensorboard, a signal to one rank stops every rank at the same step, and
the dense test splits the videos over the ranks and sums its per-video
results over them.

Usage:
  python -m dpc_tpu_torch.train.evaluate --dataset synthetic --epochs 1 \
      --steps_per_epoch 2 --batch_size 8
  python -m dpc_tpu_torch.train.evaluate --dataset ucf101 --data_root DIR \
      --pretrain <pretrain run dir> --train_what ft --epochs 300
  python -m dpc_tpu_torch.train.evaluate --dataset ucf101 --data_root DIR \
      --test <finetune run dir> --device_augment --five_crop
  python -m dpc_tpu_torch.train.evaluate --num_devices 4 --model_parallel 2 \
      --batch_size 32 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from dpc_tpu_torch.core import checkpoint as ckpt
from dpc_tpu_torch.core.config import (DataConfig, DPCConfig, EvalConfig,
                                       ExperimentConfig, TrainConfig,
                                       resolve_device)
from dpc_tpu_torch.data import augment
from dpc_tpu_torch.data.device_augment import (dense_test_crop,
                                               device_augment_geometry)
from dpc_tpu_torch.data.loader import ClipLoader
from dpc_tpu_torch.data.synthetic import SyntheticVideoDataset
from dpc_tpu_torch.data.video_dataset import make_dataset
from dpc_tpu_torch.models import lc
from dpc_tpu_torch.parallel import collectives
from dpc_tpu_torch.parallel import mesh as meshlib
from dpc_tpu_torch.train import finetune_step, loop, optim, ranks
from dpc_tpu_torch.train.metrics import (AccuracyTable, ConfusionMeter,
                                         MetricBundle, write_log)

NUM_CLASSES = {"ucf101": 101, "hmdb51": 51, "synthetic": 8}
LR_MILESTONES = {  # eval/test.py:94-98
    ("hmdb51", None): (150, 250, 300),
    ("ucf101", 224): (300, 400, 500),
}
LC_SEED = 666  # the reference's LC constructor seed (eval/model_3d_lc.py:16)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DPC finetune / linear-probe / test (PyTorch/CUDA)")
    # reference flag set (eval/test.py:25-48)
    p.add_argument("--net", default="resnet18")
    p.add_argument("--model", default="lc", choices=["lc"])
    p.add_argument("--dataset", default="ucf101",
                   choices=["ucf101", "hmdb51", "synthetic"])
    p.add_argument("--num_class", default=0, type=int,
                   help="override the per-dataset class count")
    p.add_argument("--split", default=1, type=int)
    p.add_argument("--seq_len", default=5, type=int)
    p.add_argument("--num_seq", default=8, type=int)
    p.add_argument("--ds", default=3, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--wd", default=1e-3, type=float)
    p.add_argument("--dropout", default=0.5, type=float)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--print_freq", default=5, type=int)
    p.add_argument("--reset_lr", action="store_true")
    p.add_argument("--prefix", default="tmp")
    p.add_argument("--train_what", default="ft", choices=["ft", "last"])
    p.add_argument("--img_dim", default=128, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--pretrain", default="")
    p.add_argument("--test", default="",
                   help="LC checkpoint (run dir or .pth.tar) to test; "
                        "'random' tests random weights")
    # additions of dpc_tpu
    p.add_argument("--data_root", default="")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--num_devices", default=0, type=int,
                   help="ranks to start, one a card (0: every visible "
                        "card; one on the CPU)")
    p.add_argument("--model_parallel", default=1, type=int,
                   help="model axis: shard each data group's clips over "
                        "this many ranks, BN statistics over them")
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
    p.add_argument("--log_dir", default="log_eval")
    p.add_argument("--backbone_lr_scale", default=0.1, type=float)
    p.add_argument("--remat", action="store_true",
                   help="recompute the LC forward in the backward")
    p.add_argument("--save_every_steps", default=0, type=int,
                   help="mid-epoch checkpoint interval (0 = per-epoch "
                        "only); resume continues from the exact batch")
    p.add_argument("--test_keep_short", action="store_true",
                   help="evaluate videos shorter than one clip span as one "
                        "padded window instead of dropping them like the "
                        "reference (PARITY.md #10)")
    p.add_argument("--test_tail_window", action="store_true",
                   help="append a final tail window so trailing frames are "
                        "evaluated (the reference strides only)")
    p.add_argument("--window_batch", default=0, type=int,
                   help="dense-test pooled window rows per forward over "
                        "all ranks, rounded up to a multiple of the ranks "
                        "(0 = 8 a rank)")
    p.add_argument("--five_crop", action="store_true",
                   help="dense test with the four corners and the centre; "
                        "the crops ride the window axis of the softmax "
                        "average")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of a torchrun job: join its process group "
                        "(RANK, WORLD_SIZE, MASTER_ADDR...) and read this "
                        "rank's shard of the data")
    p.add_argument("--device_augment", action="store_true",
                   help="host workers decode uint8 windows only; the "
                        "finetune, val and test recipes run on the device "
                        "(with --five_crop a test forward takes 5x "
                        "--window_batch rows)")
    p.add_argument("--fold_normalize", default="auto",
                   choices=["auto", "on", "off"],
                   help="fold the --device_augment normalize into the stem "
                        "conv; auto: on in the dense test only")
    # addition of dpc_tpu_torch
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card fails")
    return p


def config_from_args(args) -> ExperimentConfig:
    num_classes = args.num_class or NUM_CLASSES[args.dataset]
    milestones = LR_MILESTONES.get(
        (args.dataset, args.img_dim if args.dataset == "ucf101" else None),
        LR_MILESTONES.get((args.dataset, None), (60, 80, 100)))
    return ExperimentConfig(
        # gru_impl has no flag: the CLI runs the recurrence kernel, as the
        # pretrain CLI does
        model=DPCConfig(img_dim=args.img_dim, num_seq=args.num_seq,
                        seq_len=args.seq_len, network=args.net,
                        compute_dtype=args.compute_dtype, gru_impl="pallas"),
        data=DataConfig(dataset=args.dataset, data_root=args.data_root,
                        synthetic_num_videos=args.synthetic_videos,
                        split=args.split, downsample=args.ds,
                        num_workers=args.num_workers,
                        worker_mode=args.worker_mode,
                        prefetch=args.prefetch,
                        test_keep_short=args.test_keep_short,
                        test_tail_window=args.test_tail_window),
        train=TrainConfig(batch_size=args.batch_size, seed=args.seed,
                          num_devices=args.num_devices,
                          model_parallel=args.model_parallel,
                          print_freq=args.print_freq),
        eval=EvalConfig(num_classes=num_classes, dropout=args.dropout,
                        train_what=args.train_what, lr=args.lr, wd=args.wd,
                        epochs=args.epochs, batch_size=args.batch_size,
                        lr_milestones=milestones,
                        backbone_lr_scale=args.backbone_lr_scale,
                        five_crop=args.five_crop, remat=args.remat,
                        device_augment=args.device_augment,
                        fold_normalize=args.fold_normalize,
                        reset_lr=args.reset_lr),
    )


def get_dataset(cfg: ExperimentConfig, mode: str, unit_test: bool = False):
    """The ``mode`` split with the finetune recipes: a frame tree with the
    reference's (``augment.finetune_transform``, five crops in the test
    with ``five_crop``), or the synthetic videos with a random sized crop
    for train and val and the centre crop (or five) for test.  With
    ``device_augment`` only the host half, ``HostScaleCrop`` to the window
    of ``device_augment_geometry``: the whole frame at short side 240 for
    train and val (their RandomSizedCrop draws from all of it), the centre
    224² window for the test, or the frame its five crops are cut from."""
    m, d = cfg.model, cfg.data
    five = cfg.eval.five_crop and mode == "test"
    synthetic = dict(
        num_videos=d.synthetic_num_videos, video_len=d.synthetic_video_len,
        frame_size=max(m.img_dim, 130), num_seq=m.num_seq, seq_len=m.seq_len,
        downsample=d.downsample, mode=mode, return_label=True,
        num_classes=NUM_CLASSES["synthetic"],
        seed={"val": 2, "test": 3}.get(mode, 0),
        tail_window=d.test_tail_window)
    frames = dict(num_seq=m.num_seq, seq_len=m.seq_len,
                  downsample=d.downsample, split=d.split, return_label=True,
                  unit_test=unit_test, val_subsample=d.val_subsample,
                  keep_short_test=d.test_keep_short,
                  tail_window=d.test_tail_window, five_crop=five)
    if cfg.eval.device_augment:
        task = ("test_five" if five else "test") if mode == "test" \
            else "finetune"
        short, win = device_augment_geometry(d.dataset, m.img_dim, task)
        host = augment.HostScaleCrop(short, win, center=mode == "test")
        if d.dataset == "synthetic":
            return SyntheticVideoDataset(transform=host, **synthetic)
        return make_dataset(d.dataset, d.data_root, mode, host, **frames)
    if d.dataset != "synthetic":
        return make_dataset(d.dataset, d.data_root, mode,
                            augment.finetune_transform(m.img_dim, mode,
                                                       five_crop=five),
                            **frames)
    if five:
        crop = augment.FiveCrop(m.img_dim)
    else:
        crop = augment.RandomSizedCrop(size=m.img_dim,
                                       p=0.0 if mode == "test" else 1.0)
    return SyntheticVideoDataset(
        transform=augment.Compose([crop, augment.Normalize()]), **synthetic)


def run_test(cfg: ExperimentConfig, model: lc.LC, exp_dir: str, *,
             window_batch: int = 0, unit_test: bool = False,
             mesh: Optional[meshlib.Mesh] = None) -> tuple[float, float]:
    """Dense evaluation (``eval/test.py:303-342``): every video → windows →
    softmax averaged over its windows (and crops) → top-1/top-5 and the
    confusion matrix.  Windows are pooled across videos into one fixed
    ``[WB, N, SL, H, W, 3]`` batch (the tail batch padded with repeats that
    are dropped), and the host renders videos on a worker thread while the
    device runs.  Under ``--five_crop --device_augment`` each window row
    becomes K = 5 logit rows in the forward (the host five crops arrive as
    rows already, K = 1).

    On several ranks (``mesh``) each rank evaluates the videos
    ``rank::ranks`` on its own device, ``WB / ranks`` window rows a
    forward, the global ``--window_batch`` (0: 8 a rank) rounded up to a
    multiple of the ranks; the five per-video sums (float64) and the
    confusion matrix (int64) are then summed over the ranks' host group,
    and rank 0 alone prints the per-class table and writes the artifacts
    (``dpc_tpu``'s multihost case, ``dpc_tpu/train/evaluate.py:281-306,
    440-479``).  Returns (loss, top1), the same on every rank."""
    e = cfg.eval
    device = next(model.parameters()).device
    ranks_n = mesh.size if mesh else 1
    rank = mesh.rank if mesh else 0
    ds = get_dataset(cfg, "test", unit_test)
    wb = window_batch or 8 * ranks_n
    wb = -(-wb // ranks_n) * ranks_n
    rank_wb = wb // ranks_n
    k_crops = 5 if (e.five_crop and e.device_augment) else 1
    forward = finetune_step.make_test_forward(
        cfg.model, e, model,
        test_crop=dense_test_crop(cfg.data.dataset, cfg.model.img_dim))
    confusion = ConfusionMeter(e.num_classes)
    top1s, top5s, losses = [], [], []
    q: queue.Queue = queue.Queue(maxsize=4)

    def producer():
        rng = np.random.default_rng(0)
        try:
            for i in range(rank, len(ds), ranks_n):
                q.put((i, ds.sample(i, rng)))
        except Exception as exc:  # surfaced to the consumer below
            q.put(exc)
        finally:
            q.put(None)

    threading.Thread(target=producer, daemon=True).start()

    buf: list[np.ndarray] = []       # window slices pending a forward
    meta: list[tuple[int, int]] = []  # (video, rows) per slice
    chunks: dict[int, list[np.ndarray]] = {}
    counts: dict[int, int] = {}
    labels: dict[int, int] = {}
    n_windows = 0

    def finalize(vid: int) -> None:
        logits = np.concatenate(chunks.pop(vid), axis=0)  # [nw, classes]
        label = labels.pop(vid)
        z = logits - logits.max(axis=-1, keepdims=True)
        probs = np.exp(z)
        probs /= probs.sum(axis=-1, keepdims=True)
        order = np.argsort(-probs.mean(axis=0))
        top1s.append(float(order[0] == label))
        top5s.append(float(label in order[:5]))
        mean_logits = logits.mean(axis=0)
        zl = mean_logits - mean_logits.max()
        losses.append(float(np.log(np.exp(zl).sum()) - zl[label]))
        confusion.update(np.asarray([order[0]]), np.asarray([label]))

    def flush() -> None:
        nonlocal buf, meta, n_windows
        if not meta:
            return
        rows = np.concatenate(buf, axis=0)
        r = rows.shape[0]
        n_windows += r * k_crops
        if r < rank_wb:  # tail batch: pad with repeats, dropped below
            rows = np.concatenate([rows,
                                   np.repeat(rows[-1:], rank_wb - r, 0)])
        x = torch.from_numpy(rows).to(device)
        logits = forward(x).float().cpu().numpy()[:r * k_crops]
        ofs = 0
        for vid, cnt in meta:
            cnt *= k_crops  # a row's crops are contiguous
            chunks.setdefault(vid, []).append(logits[ofs:ofs + cnt])
            ofs += cnt
            if sum(a.shape[0] for a in chunks[vid]) == counts[vid]:
                finalize(vid)
        buf, meta = [], []

    t0 = time.perf_counter()
    space = rank_wb
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, Exception):
            raise item
        vid, (clip, label) = item
        counts[vid], labels[vid] = clip.shape[0] * k_crops, int(label)
        ofs = 0
        while ofs < clip.shape[0]:
            take = min(space, clip.shape[0] - ofs)
            buf.append(clip[ofs:ofs + take])
            meta.append((vid, take))
            ofs += take
            space -= take
            if space == 0:
                flush()
                space = rank_wb
    flush()
    sums = torch.tensor([sum(top1s), sum(top5s), sum(losses), len(top1s),
                         n_windows], dtype=torch.float64)
    mat = torch.from_numpy(confusion.mat.astype(np.int64))
    if mesh is not None:  # the ranks' host group: gloo, CPU tensors
        collectives.sum_(sums, mesh.host_group)
        collectives.sum_(mat, mesh.host_group)
        confusion.mat = mat.numpy()
    dt = time.perf_counter() - t0
    *totals, n_videos, n_windows = sums.tolist()
    top1, top5, loss = (v / n_videos if n_videos else float("nan")
                        for v in totals)
    print(f"[test] loss {loss:.4f}; top1 {top1:.4f}; top5 {top5:.4f}")
    print(f"[test] {int(n_windows)} windows / {len(ds)} videos in "
          f"{dt:.1f}s = {n_windows / dt:.1f} windows/s (WB={wb}"
          + (f" over {ranks_n} ranks)" if ranks_n > 1 else ")"))
    loop.report_fallbacks(ds)
    if rank == 0:
        table = AccuracyTable()
        for t_cls in range(e.num_classes):
            cnt = int(confusion.mat[:, t_cls].sum())
            if cnt:
                table.dict[t_cls] = {
                    "count": cnt, "correct": int(confusion.mat[t_cls, t_cls])}
        table.print_table("test")
        os.makedirs(exp_dir, exist_ok=True)
        confusion.save(os.path.join(exp_dir, "confusion_matrix.txt"))
        write_log(content=f"loss: {loss:.4f}; top1: {top1:.4f}; "
                          f"top5: {top5:.4f}",
                  epoch=0, filename=os.path.join(exp_dir, "test_log.md"))
    return loss, top1


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ranks.run(main, argv, args, device,
              lambda n_data, n_model: finetune_step.check_layout(
                  args.batch_size, n_data, n_model),
              lambda world: _run(args, device, world))


def _run(args, device: torch.device, world: int) -> None:
    cfg = config_from_args(args)
    m, e, t = cfg.model, cfg.eval, cfg.train
    mesh, device = ranks.mesh_and_device(device, world, t.model_parallel)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + f"; dtype={m.compute_dtype}"
          + (f"; devices: {mesh.shape}" if world > 1 else ""))
    if mesh.size == 1:
        mesh = None
    rank0 = mesh is None or mesh.rank == 0

    exp_dir = (args.resume if args.resume else os.path.join(
        args.log_dir,
        f"{args.prefix}_{args.dataset}-{m.img_dim}-sp{args.split}"
        f"_r{m.network[6:]}_lc_bs{t.batch_size}_lr{e.lr}"
        f"_wd{e.wd}_dp{e.dropout}_train-{e.train_what}"))
    if rank0:
        os.makedirs(exp_dir, exist_ok=True)
        with open(os.path.join(exp_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    model = lc.build_lc(m, e.num_classes, device, dropout=e.dropout,
                        seed=LC_SEED)
    if args.test:
        if args.test == "random":
            print("[warning] testing RANDOM weights")
        else:
            sd, epoch = ckpt.state_dict_of(args.test, best=True)
            try:  # strict, then by name (eval/test.py:106-114)
                model.load_state_dict(sd)
            except RuntimeError:
                print("[warning] the checkpoint's weights do not match the "
                      "test model exactly; loading the matching names")
                ckpt.transfer_load(model, sd)
            print(f"loaded test checkpoint {args.test}"
                  + (f" epoch {epoch}" if epoch is not None else ""))
        run_test(cfg, model, exp_dir, window_batch=args.window_batch,
                 unit_test=args.unit_test, mesh=mesh)
        return

    if args.pretrain:
        ckpt.load_pretrained(args.pretrain, model, verbose=rank0)
    opt = optim.finetune_optimizer(model, e.lr, e.wd, e.train_what,
                                   e.backbone_lr_scale)

    def restore(payload: dict) -> None:
        """Parameters and running statistics, and the optimizer unless
        --reset_lr asks for a fresh one."""
        model.load_state_dict(payload["state_dict"])
        if not e.reset_lr:
            opt.load_state_dict(payload["optimizer"])

    mgr = ckpt.CheckpointManager(os.path.join(exp_dir, "model"))
    start_epoch, best_acc = args.start_epoch, 0.0
    if args.resume:
        epoch0, payload = ckpt.restore_latest(mgr)
        if epoch0 is not None:
            restore(payload)
            best_acc = float(payload["best_acc"])
            start_epoch = epoch0
            print(f"resumed epoch {epoch0} (best_acc {best_acc:.4f})")
        else:
            print(f"[Warning] no checkpoint found at '{args.resume}'")
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
            print(f"resumed mid-epoch: epoch {start_epoch} "
                  f"batch {start_batch}")
    # every rank starts from rank 0's parameters and running statistics
    collectives.broadcast_(list(model.parameters()) + list(model.buffers()),
                           mesh and mesh.world_group)

    n_total = sum(p.numel() for p in model.parameters())
    trunk = sum(p.numel() for name in optim.TRUNK
                for p in getattr(model, name).parameters())
    print(f"params: {n_total / 1e6:.2f}M total; trunk {trunk / 1e6:.2f}M "
          f"({'frozen' if e.train_what == 'last' else f'lr x{e.backbone_lr_scale}'}"
          f"); head at full lr")
    step = loop.RematRetry(
        lambda remat: finetune_step.make_finetune_step(
            m, dataclasses.replace(e, remat=remat), model, opt, mesh),
        model, opt, e.remat, retry=mesh is None)
    eval_step = finetune_step.make_finetune_eval_step(m, e, model, mesh)
    gen = torch.Generator(device=device)
    aug_gen = torch.Generator()  # the device recipe's draws, made on the host
    augmenting = e.device_augment
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
        ckpt.write_on_rank0(lambda: ckpt.save_step_unless_duplicate(
            step_mgr, ckpt.mid_epoch_step_id(ep, batch_idx),
            lambda: {"epoch": ep, "batch_idx": batch_idx, "net": m.network,
                     "state_dict": model.state_dict(),
                     "optimizer": opt.state_dict(), "best_acc": best_acc}),
            mesh)

    guard = (loop.PreemptionGuard(mesh and mesh.host_group).install()
             if step_mgr else None)
    try:
        for epoch in range(start_epoch, e.epochs):
            train_loader.set_epoch(epoch)
            val_loader.set_epoch(epoch)
            lr_scale = optim.multistep_restart_lr(
                epoch, 1.0, e.lr_milestones, e.lr_gamma, e.lr_repeat)

            def train_dispatch(idx, batch, epoch=epoch, lr_scale=lr_scale):
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
                return step(reseed, *to_device(batch), gen, lr_scale,
                            aug_gen)

            def val_dispatch(idx, batch, epoch=epoch):
                if augmenting:
                    aug_gen.manual_seed(meshlib.data_seed(
                        mesh, loop.step_seed(t.seed, epoch, idx,
                                             loop.VAL_AUGMENT)))
                return eval_step(*to_device(batch), aug_gen)

            n_train = len(train_loader)
            train_done = (min(n_train, args.steps_per_epoch)
                          if args.steps_per_epoch else n_train)

            def save_from_val(ep, _val_idx):
                save_mid_epoch(ep, train_done - 1)

            def log_input_grid(batch, epoch=epoch):
                # once a run, from the batch already in hand
                # (eval/test.py:232-238)
                writer_train.add_images("input_seq", loop.input_grid(batch[0]),
                                        epoch, dataformats="NHWC")

            meters, vmeters = MetricBundle(), MetricBundle()
            t0 = time.perf_counter()
            n = loop.run_epoch(
                train_dispatch, train_loader, meters, mode="train",
                print_freq=t.print_freq, epoch=epoch,
                max_steps=args.steps_per_epoch,
                start_batch=start_batch if epoch == start_epoch else 0,
                step_save_fn=save_mid_epoch if step_mgr else None,
                save_every_steps=args.save_every_steps, guard=guard,
                first_batch_fn=(log_input_grid if writer_train is not None
                                and epoch == start_epoch else None))
            dt = time.perf_counter() - t0
            nv = loop.run_epoch(
                val_dispatch, val_loader, vmeters, mode="val",
                print_freq=t.print_freq, epoch=epoch,
                max_steps=args.steps_per_epoch,
                step_save_fn=save_from_val if step_mgr else None,
                guard=guard, train=False)
            tr, va = meters.averages(), vmeters.averages()
            print(f"epoch {epoch}: train top1 {tr.get('top1', 0):.4f} | "
                  f"val top1 {va.get('top1', 0):.4f}")
            print(f"[epoch {epoch}] {n} train steps in {dt:.1f} s, train "
                  f"loss {tr.get('loss', 0.0):.4f}; {nv} val steps, val "
                  f"loss {va.get('loss', 0.0):.4f}", flush=True)
            if writer_train is not None:
                for k, v in tr.items():
                    writer_train.add_scalar(f"global/{k}", v, epoch)
                for k, v in va.items():
                    writer_val.add_scalar(f"global/{k}", v, epoch)
                writer_train.add_scalar("lr/scale", lr_scale, epoch)
            val_acc = va.get("top1", 0.0)
            best_acc = max(best_acc, val_acc)
            if rank0:
                write_log(content=f"train top1 {tr.get('top1', 0.0):.4f}; "
                                  f"val top1 {val_acc:.4f}",
                          epoch=epoch,
                          filename=os.path.join(exp_dir, "train_log.md"))
            ckpt.write_on_rank0(lambda: mgr.save(
                epoch + 1,
                {"epoch": epoch + 1, "net": m.network,
                 "state_dict": model.state_dict(),
                 "optimizer": opt.state_dict(), "best_acc": best_acc},
                val_acc=val_acc), mesh)
    finally:
        train_loader.close()
        val_loader.close()
        loop.close_tensorboard(writer_train, writer_val)
        if guard is not None:
            guard.uninstall()
    loop.report_fallbacks(train_loader.dataset, val_loader.dataset)
    print(f"Finetune from ep {start_epoch} to ep {e.epochs} finished; "
          f"best val top1 {best_acc:.4f}")


if __name__ == "__main__":
    main()
