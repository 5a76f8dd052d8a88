"""The epoch loop both CLIs share (port of ``dpc_tpu/train/loop.py``).

The reference hot loops (``dpc/main.py:187-246``, ``eval/test.py:218-277``)
read every metric as soon as its step is queued, which makes the host wait
for the device every step.  Here a step's metrics (0-d device tensors) are
read only after the NEXT step has been queued: a one-step-deep drain, so
the host prepares and queues step i+1 while the device runs step i.  Also
home to what both drivers need to survive: the SIGTERM/SIGINT preemption
guard and the out-of-memory test behind the ``--remat`` retry.
"""

from __future__ import annotations

import math
import signal
import time

import numpy as np
import torch


class PreemptionGuard:
    """SIGTERM/SIGINT → finish the current step, checkpoint, exit cleanly.
    Installed by the drivers when mid-epoch checkpoints are on."""

    def __init__(self):
        self.requested = False
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
                 optimizer: torch.optim.Optimizer, remat: bool):
        self.make_step = make_step
        self.model = model
        self.optimizer = optimizer
        self.step = make_step(remat)
        self.checked = remat

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


def step_seed(seed: int, epoch: int, idx: int) -> int:
    """The dropout seed of train step ``idx`` of ``epoch``: derived, not
    carried, so a run resumed at any step draws what the uninterrupted run
    drew there."""
    return int(np.random.SeedSequence((seed, epoch, idx)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _rows_of(batch) -> int:
    if isinstance(batch, (tuple, list)):
        batch = batch[0]
    return batch.shape[0]


def run_epoch(dispatch, loader, meters, *, mode: str = "train",
              print_freq: int = 5, epoch: int = 0, print_fn=None,
              max_steps: int = 0, start_batch: int = 0,
              step_save_fn=None, save_every_steps: int = 0,
              guard=None, train: bool = True) -> int:
    """Drive one epoch, one step deep.

    ``dispatch(idx, batch)`` queues step ``idx`` and returns its metrics as
    0-d device tensors.  They are read (``float()``) after the following
    step is queued, so the finite-loss check and the progress line lag the
    queued step by one.  A non-finite train loss raises; a non-finite val
    loss warns, so that a finished train epoch still reaches its
    checkpoint.  ``step_save_fn(epoch, idx)`` persists the state after step
    ``idx``: every ``save_every_steps`` train steps, and on preemption,
    after which the loop exits with ``SystemExit``.  ``print_fn(idx,
    metrics)`` is called with every printed step.  Returns the number of
    steps run.
    """
    tic = time.time()
    it = loader.iterate(start_batch) if hasattr(loader, "iterate") \
        else iter(loader)
    pending = None  # (idx, device metrics, batch rows)
    steps = 0

    def drain(entry):
        nonlocal tic
        p_idx, dev_metrics, rows = entry
        metrics = {k: float(v) for k, v in dev_metrics.items()}
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
        last_idx = idx
        metrics = dispatch(idx, batch)
        steps += 1
        if pending is not None:
            drain(pending)
        pending = (idx, metrics, _rows_of(batch))
        preempted = guard is not None and guard.requested
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
    if guard is not None and guard.requested and steps > 0:
        if step_save_fn is not None:
            step_save_fn(epoch, last_idx)
        raise SystemExit("[preemption] checkpointed and exiting")
    return steps
