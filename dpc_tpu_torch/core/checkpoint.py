"""Checkpoint save / resume / transfer-load with ``torch.save`` (the port of
``dpc_tpu/core/checkpoint.py``, whose Orbax manager becomes a directory of
``.pth.tar`` files with the same semantics).

  * Rolling latest plus one best by ``val_acc`` (``utils/utils.py:14-26`` of
    the reference): ``epoch{N}.pth.tar`` and ``model_best_epoch{N}.pth.tar``.
  * Epoch files hold the reference's layout, ``{"epoch", "net",
    "state_dict", "optimizer", "best_acc", "iteration", "val_acc"}``, with
    the reference's state_dict names, so ``dpc_tpu``'s ``load_pretrained``
    and the reference read them, and a reference ``.pth.tar`` loads here
    natively.
  * Every write is atomic: a temporary file in the same directory, flushed
    to disk, then renamed over the target.
  * Mid-epoch step files (``step{id}.pth.tar`` in their own directory) add
    ``batch_idx`` and resume from the exact batch.
  * Across ranks, rank 0 writes and every rank waits for it at a barrier
    (``write_on_rank0``); every rank reads the files on resume.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

_EPOCH = re.compile(r"^epoch(\d+)\.pth\.tar$")
_BEST = re.compile(r"^model_best_epoch(\d+)\.pth\.tar$")
_STEP = re.compile(r"^step(\d+)\.pth\.tar$")


def is_torch_file(path: str) -> bool:
    """One definition of "a torch checkpoint file" for ``--pretrain``,
    ``--test`` and ``--resume``: anything else is a run directory."""
    return path.endswith((".pth", ".tar", ".pt"))  # .pth.tar ⊂ .tar


def atomic_save(obj: dict, path: str) -> None:
    """``torch.save`` to a temporary file beside ``path``, fsync, rename: a
    reader never sees a half-written checkpoint, and a crash leaves the old
    one in place."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_file(path: str) -> dict:
    """Read a checkpoint file onto the CPU (tensors and plain types only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """A directory of checkpoints named by an integer step (the epoch for
    epoch files, :func:`mid_epoch_step_id` for step files).  Keeps the
    newest, plus, with ``keep_best``, a copy of the one with the highest
    ``val_acc``."""

    def __init__(self, directory: str, *, keep_best: bool = True,
                 step_files: bool = False, read_only: bool = False):
        self.directory = os.path.abspath(directory)
        self.keep_best = keep_best
        self._pattern, self._name = ((_STEP, "step{}.pth.tar") if step_files
                                     else (_EPOCH, "epoch{}.pth.tar"))
        if read_only:
            if not os.path.isdir(self.directory):
                raise FileNotFoundError(
                    f"no checkpoint directory {self.directory}")
        else:
            os.makedirs(self.directory, exist_ok=True)

    def _steps(self, pattern) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(pattern.match, os.listdir(self.directory)) if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, self._name.format(step))

    def best_path(self, step: int) -> str:
        return os.path.join(self.directory, f"model_best_epoch{step}.pth.tar")

    def latest_step(self) -> Optional[int]:
        steps = self._steps(self._pattern)
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        steps = self._steps(_BEST)
        return steps[-1] if steps else None

    def _best_acc(self) -> Optional[float]:
        step = self.best_step()
        if step is None:
            return None
        # mmap: reads the small header, not the tensors
        return float(torch.load(self.best_path(step), map_location="cpu",
                                weights_only=True, mmap=True)["val_acc"])

    def save(self, step: int, payload: dict,
             val_acc: Optional[float] = None) -> None:
        """Write ``payload`` as ``step``; with ``keep_best`` and a
        ``val_acc`` higher than the best so far (or no best yet), also as
        the best.  Then drop the files retention no longer keeps."""
        if val_acc is not None:
            payload = {**payload, "val_acc": float(val_acc)}
        atomic_save(payload, self.path(step))
        if self.keep_best and val_acc is not None:
            best = self._best_acc()
            if best is None or val_acc > best:
                old = self.best_step()
                tmp = f"{self.best_path(step)}.tmp-{os.getpid()}"
                shutil.copyfile(self.path(step), tmp)
                os.replace(tmp, self.best_path(step))
                if old is not None and old != step:
                    os.remove(self.best_path(old))
        for old in self._steps(self._pattern)[:-1]:
            os.remove(self.path(old))

    def restore(self, step: int) -> dict:
        return load_file(self.path(step))


def write_on_rank0(write: Callable[[], None], mesh=None) -> None:
    """Run ``write`` on rank 0 alone, then hold every rank at a barrier of
    the host group until it is done, so that no rank goes on to read a
    checkpoint, or to end the run, while it is being written.  One rank
    (``mesh`` None or of size 1): ``write()``."""
    if mesh is None or mesh.size == 1:
        write()
        return
    if mesh.rank == 0:
        write()
    dist.barrier(group=mesh.host_group)


def restore_latest(mgr: CheckpointManager) -> tuple[Optional[int],
                                                     Optional[dict]]:
    """(step, payload) of the newest checkpoint, or (None, None)."""
    step = mgr.latest_step()
    if step is None:
        return None, None
    return step, mgr.restore(step)


def restore_best(mgr: CheckpointManager) -> tuple[Optional[int],
                                                   Optional[dict]]:
    """(step, payload) of the best checkpoint, else of the newest."""
    step = mgr.best_step()
    if step is None:
        return restore_latest(mgr)
    return step, load_file(mgr.best_path(step))


# ---------------------------------------------------------------------------
# Mid-epoch (step-level) checkpoints: both drivers go through these helpers,
# so the id written and the resume gate cannot drift apart.
# ---------------------------------------------------------------------------

def mid_epoch_step_id(epoch: int, batch_idx: int, offset: int = 0) -> int:
    """Monotone id of a mid-epoch checkpoint.  ``offset`` lets the pretrain
    driver fold in its live iteration so ids stay monotone when
    ``--steps_per_epoch`` cuts epochs; the finetune driver passes 0.  A
    batch index must stay below 100000."""
    if batch_idx >= 100000:
        raise ValueError(f"mid-epoch step id would collide: batch "
                         f"{batch_idx} >= 100000 per-epoch namespace")
    return offset + batch_idx + epoch * 100000


def save_step_unless_duplicate(step_mgr: CheckpointManager, sid: int,
                               payload_fn: Callable[[], dict]) -> None:
    """Save a mid-epoch checkpoint unless ``sid`` is already the newest: a
    val-time preemption re-requests the train position, and the
    epoch-boundary guard can follow a periodic save of the same step.
    ``payload_fn`` builds the payload only when it is written."""
    if step_mgr.latest_step() == sid:
        return
    step_mgr.save(sid, payload_fn())


def resume_mid_epoch(mgr: CheckpointManager, start_epoch: int
                     ) -> tuple[Optional[dict], int, int]:
    """The newest step checkpoint is honoured only when it is at or after
    the epoch-level resume point (an epoch file written later supersedes
    stale step files).  Returns ``(payload | None, start_epoch,
    start_batch)``, ``start_batch`` being the first batch not yet run."""
    _, payload = restore_latest(mgr)
    if payload is None or int(payload["epoch"]) < start_epoch:
        return None, start_epoch, 0
    return payload, int(payload["epoch"]), int(payload["batch_idx"]) + 1


# ---------------------------------------------------------------------------
# Transfer loading (the reference's neq_load_customized)
# ---------------------------------------------------------------------------

def _strip_module(sd: dict) -> dict:
    """Drop DataParallel's ``module.`` prefix from reference files."""
    return {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}


def transfer_load(model: nn.Module, source: dict,
                  verbose: bool = True) -> nn.Module:
    """Copy every tensor whose name exists in both ``model.state_dict()``
    and ``source`` with the same shape; report the rest (the DPC → LC
    transfer, ``backbone/resnet_2d3d.py:310-333``)."""
    target = model.state_dict()
    source = _strip_module(source)
    loaded, shape_mismatch = {}, []
    for name, val in source.items():
        if name in target:
            if tuple(target[name].shape) == tuple(val.shape):
                loaded[name] = val
            else:
                shape_mismatch.append(name)
    model.load_state_dict(loaded, strict=False)
    if verbose:
        unused = [k for k in source if k not in target]
        missing = [k for k in target if k not in source]
        print(f"[transfer_load] loaded {len(loaded)} tensors; "
              f"{len(unused)} unused; {len(missing)} not-loaded; "
              f"{len(shape_mismatch)} shape-mismatched")
        for k in unused:
            print("  unused:", k)
        for k in missing:
            print("  missing:", k)
        for k in shape_mismatch:
            print("  shape-mismatch:", k)
    return model


def state_dict_of(path: str, *, best: bool = False
                  ) -> tuple[dict, Optional[int]]:
    """The ``state_dict`` of a ``.pth.tar`` file, or of a run directory's
    newest epoch file (its best with ``best=True``).  Returns
    ``(state_dict, epoch)``, the epoch None for a file."""
    if is_torch_file(path):
        ck = load_file(path)
        return _strip_module(ck.get("state_dict", ck)), None
    if os.path.isdir(os.path.join(path, "model")):  # run dir → model/
        path = os.path.join(path, "model")
    mgr = CheckpointManager(path, read_only=True)
    step, payload = restore_best(mgr) if best else restore_latest(mgr)
    if payload is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return payload["state_dict"], step


def load_pretrained(path: str, model: nn.Module,
                    verbose: bool = True) -> nn.Module:
    """``--pretrain``: a reference ``.pth.tar`` or a run directory of
    either package's torch checkpoints, transfer-loaded into ``model``
    (``dpc/main.py:104-112``, ``eval/test.py:149-158``)."""
    sd, _ = state_dict_of(path)
    return transfer_load(model, sd, verbose=verbose)
