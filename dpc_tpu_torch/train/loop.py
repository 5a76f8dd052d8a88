"""The epoch loop both CLIs share (port of ``dpc_tpu/train/loop.py``).

The reference hot loops (``dpc/main.py:187-246``, ``eval/test.py:218-277``)
read every metric as soon as its step is queued, which makes the host wait
for the device every step.  Here a step's metrics (0-d device tensors) are
read only after the NEXT step has been queued: a one-step-deep drain, so
the host prepares and queues step i+1 while the device runs step i.  Also
home to what both drivers need to survive: the SIGTERM/SIGINT preemption
guard and the out-of-memory test behind the ``--remat`` retry; and to
their tensorboard writers, which exist only where ``tensorboardX``
imports.
"""

from __future__ import annotations

import math
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from dpc_tpu_torch.data.video_dataset import count_fallbacks
from dpc_tpu_torch.train.metrics import denormalize


class PreemptionGuard:
    """SIGTERM/SIGINT → finish the current step, checkpoint, exit cleanly.
    Installed by the drivers when mid-epoch checkpoints are on.  With a
    host ``group`` of several ranks, ``agreed()`` is the flag's max over
    the ranks, so a signal to one rank stops every rank at the same step
    (a rank that stopped alone would leave the others waiting in a
    collective)."""

    def __init__(self, group=None):
        self.requested = False
        self.group = group
        self._prev = {}

    def install(self) -> "PreemptionGuard":
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        print(f"[preemption] signal {signum} received; will checkpoint "
              "after the current step", flush=True)
        self.requested = True

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def agreed(self) -> bool:
        """Whether a stop was requested on any rank; every rank calls this
        at the same points of the loop.  One rank: its own flag, no
        collective."""
        if self.group is None:
            return self.requested
        flag = torch.tensor([int(self.requested)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        # a signal that lands during the all-reduce counts at the next call
        agreed = bool(flag.item())
        self.requested = self.requested or agreed
        return agreed


def is_oom(exc: BaseException) -> bool:
    """True when a step failed for want of device memory: the case the
    drivers recover from by rebuilding the step with activation
    checkpointing instead of dying."""
    return isinstance(exc, torch.cuda.OutOfMemoryError)


class RematRetry:
    """A train step that survives a first step too large for the device:
    ``make_step(remat)`` builds the step; when the run's first call fails
    for want of device memory, the model's buffers (BN running statistics,
    which the failed forward may have updated) are put back, the step is
    rebuilt with activation checkpointing, ``reseed()`` rewinds the
    dropout generator, and the same batch runs again.  Later calls run the
    step as it is."""

    def __init__(self, make_step, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, remat: bool,
                 retry: bool = True):
        self.make_step = make_step
        self.model = model
        self.optimizer = optimizer
        self.step = make_step(remat)
        # no retry on several ranks: the others would wait in a collective
        # of the failed step, so a rank out of memory fails the run
        self.checked = remat or not retry

    def __call__(self, reseed, *args):
        if self.checked:
            return self.step(*args)
        saved = {k: v.clone() for k, v in self.model.named_buffers()}
        try:
            out = self.step(*args)
            failed = False
        except Exception as exc:
            if not is_oom(exc):
                raise
            failed = True
        if failed:  # outside the handler: its traceback holds tensors
            print("[memory] step does not fit the device; retrying with "
                  "activation checkpointing (--remat)", flush=True)
            for k, v in self.model.named_buffers():
                v.copy_(saved[k])
            self.optimizer.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            self.step = self.make_step(True)
            reseed()
            out = self.step(*args)
        self.checked = True
        return out


# the random streams of a step: dropout, and the device recipes' draws
DROPOUT, TRAIN_AUGMENT, VAL_AUGMENT = 0, 1, 2


def step_seed(seed: int, epoch: int, idx: int, stream: int = DROPOUT) -> int:
    """The seed of ``stream`` at step ``idx`` of ``epoch``: derived, not
    carried, so a run resumed at any step draws what the uninterrupted run
    drew there."""
    entropy = (seed, epoch, idx) if stream == DROPOUT else (seed, epoch, idx,
                                                           stream)
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class DeviceFeed:
    """Host batches to the device.  On a card the copy runs on a side
    stream from pinned memory and the compute stream waits for it, so the
    copy of batch i+1 overlaps step i (the loop queues one step ahead);
    on the CPU it hands the tensors through."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def __call__(self, batch):
        """A tensor or array, or a tuple of them."""
        if isinstance(batch, (tuple, list)):
            return tuple(self(b) for b in batch)
        t = batch if isinstance(batch, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(batch))
        if self.stream is None:
            return t.to(self.device)
        if not t.is_pinned():
            t = t.pin_memory()
        with torch.cuda.stream(self.stream):
            out = t.to(self.device, non_blocking=True)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_stream(self.stream)
        out.record_stream(compute)
        return out


def report_fallbacks(*datasets) -> None:
    """Print the planned-decode fallbacks of the datasets that plan (the
    ``--device_augment`` host half); nothing for the others."""
    fallbacks = count_fallbacks(*datasets)
    if fallbacks is not None:
        print(f"[feed] planned-decode fallbacks: {fallbacks}", flush=True)


def open_tensorboard(exp_dir: str) -> tuple:
    """``(train writer, val writer)`` under ``exp_dir/img/{train,val}``
    where ``tensorboardX`` imports; else ``(None, None)`` after a
    ``tensorboard disabled: ...`` line, and the run goes on without."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        print(f"tensorboard disabled: {e}")
        return None, None
    return (SummaryWriter(logdir=os.path.join(exp_dir, "img", "train")),
            SummaryWriter(logdir=os.path.join(exp_dir, "img", "val")))


def close_tensorboard(*writers) -> None:
    """Flush and close the writers that exist: a preemption's exit must
    not drop the run's last scalars."""
    for w in writers:
        if w is not None:
            w.close()


def input_grid(clips) -> np.ndarray:
    """The ``input_seq`` image: the first 16 frames of ``clips [..., H, W,
    3]`` (host array or tensor; the pretrain CLI passes the batch's first
    clip, the finetune CLI the batch, as ``dpc_tpu``'s), NHWC in [0, 1].
    Normalised clips are ``denormalize``d; the uint8 windows of
    ``--device_augment`` are divided by 255 (``denormalize`` would
    saturate them to white)."""
    clips = clips.numpy() if isinstance(clips, torch.Tensor) else clips
    frames = np.asarray(clips).reshape(-1, *clips.shape[-3:])[:16]
    if frames.dtype == np.uint8:
        return frames.astype(np.float32) / 255.0
    return denormalize(frames)


class MetricsFetch:
    """A step's metrics on their way to the host.  Each 0-d CUDA tensor is
    copied into pinned host memory on the current stream right behind the
    step that made it, and an event marks the copies' end, so reading the
    values waits for that step alone.  Reading the device tensors instead
    would queue the copy behind every step queued since, and wait for them
    too: the one-deep drain would wait for the step it means to overlap
    (``dpc_tpu``'s loop starts the same copies with
    ``copy_to_host_async``).  CPU values pass through."""

    def __init__(self, metrics: dict):
        self.values, self.event = dict(metrics), None
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                self.values[k] = host.copy_(v, non_blocking=True)
                if self.event is None:
                    self.event = torch.cuda.Event()
        if self.event is not None:
            self.event.record()

    def get(self) -> dict[str, float]:
        if self.event is not None:
            self.event.synchronize()
        return {k: float(v) for k, v in self.values.items()}


def _rows_of(batch) -> int:
    if isinstance(batch, (tuple, list)):
        batch = batch[0]
    return batch.shape[0]


def run_epoch(dispatch, loader, meters, *, mode: str = "train",
              print_freq: int = 5, epoch: int = 0, print_fn=None,
              max_steps: int = 0, start_batch: int = 0,
              step_save_fn=None, save_every_steps: int = 0,
              guard=None, first_batch_fn=None, train: bool = True) -> int:
    """Drive one epoch, one step deep.

    ``dispatch(idx, batch)`` queues step ``idx`` and returns its metrics as
    0-d device tensors.  Their copy to the host starts at once
    (``MetricsFetch``); they are read after the following step is queued,
    so the finite-loss check and the progress line lag the queued step by
    one, and the device runs step ``idx + 1`` while the host waits for
    step ``idx``.  A non-finite train loss raises; a non-finite val
    loss warns, so that a finished train epoch still reaches its
    checkpoint.  ``step_save_fn(epoch, idx)`` persists the state after step
    ``idx``: every ``save_every_steps`` train steps, and on preemption
    (``guard.agreed()``, read once a step and at the epoch's end), after
    which the loop exits with ``SystemExit``.  ``print_fn(idx,
    metrics)`` is called with every printed step, ``first_batch_fn(batch)``
    with the epoch's first host batch before it is dispatched.  Returns the
    number of steps run.
    """
    tic = time.time()
    it = loader.iterate(start_batch) if hasattr(loader, "iterate") \
        else iter(loader)
    pending = None  # (idx, MetricsFetch, batch rows)
    steps = 0

    def drain(entry):
        nonlocal tic
        p_idx, fetch, rows = entry
        metrics = fetch.get()
        if not math.isfinite(metrics.get("loss", 0.0)):
            if train:
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch} step {p_idx}: "
                    f"{metrics}")
            print(f"[{mode}] WARNING: non-finite loss at epoch {epoch} "
                  f"step {p_idx}: {metrics}", flush=True)
        meters.update(metrics, n=rows)
        if p_idx % print_freq == 0:
            dt = time.time() - tic
            tic = time.time()
            print(f"[{mode}] epoch {epoch} [{p_idx}/{len(loader)}] "
                  + " ".join(f"{k} {v:.4f}" for k, v in metrics.items())
                  + f" ({dt:.2f}s)", flush=True)
            if print_fn is not None:
                print_fn(p_idx, metrics)

    last_idx = start_batch - 1  # the last queued batch
    for idx, batch in enumerate(it, start=start_batch):
        if max_steps and idx >= max_steps:
            break
        if first_batch_fn is not None:
            first_batch_fn(batch)
            first_batch_fn = None
        last_idx = idx
        fetch = MetricsFetch(dispatch(idx, batch))
        steps += 1
        if pending is not None:
            drain(pending)
        pending = (idx, fetch, _rows_of(batch))
        preempted = guard is not None and guard.agreed()
        # val epochs save only on preemption (the caller's step_save_fn
        # decides what that persists); periodic saves are train-only
        if (step_save_fn is not None
                and (preempted or (train and save_every_steps
                                   and (idx + 1) % save_every_steps == 0))):
            # the file persists step idx's update: check that step's loss
            # first, so a non-finite step is never saved and resumed from
            drain(pending)
            pending = None
            step_save_fn(epoch, idx)
        if preempted:
            if pending is not None:
                drain(pending)
            raise SystemExit("[preemption] checkpointed and exiting")
    if pending is not None:
        drain(pending)
    # a signal that lands during the last step's drain exits here, at the
    # epoch boundary, with the position of the steps completed
    if guard is not None and guard.agreed() and steps > 0:
        if step_save_fn is not None:
            step_save_fn(epoch, last_idx)
        raise SystemExit("[preemption] checkpointed and exiting")
    return steps
