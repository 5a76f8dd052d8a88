"""Tracing, profiling and debug hooks (port of
``dpc_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` over the CPU and the card around a
  block, written as a Chrome trace (``--profile`` of the pretrain CLI);
* :class:`StepTimer`: step timing that waits for the card (PyTorch queues
  CUDA work and returns, so a host clock alone times the enqueue);
* :func:`enable_debug`: anomaly mode, which raises on the first NaN a
  backward function returns, and the finite-loss check the train step runs
  while it is on (``--debug_nans``);
* :func:`device_busy` and :func:`kernels_by_op`: how a profile is read.
  The busy share is defined here once: the device time of kernels, copies
  and sets, without the GPU ranges of user annotations (the optimizer's
  step, for one), whose kernels would count twice, over wall time.

``dpc_tpu``'s ``enable_compilation_cache`` has no counterpart: it is JAX's
compilation cache.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], record_shapes: bool = False
          ) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile everything inside the block (the CPU, and the card where
    there is one) and write it to a Chrome trace in ``log_dir``; yields
    the profiler, whose tables the caller may read after the block.  A
    no-op yielding None when ``log_dir`` is empty.  View the trace in
    Perfetto or ``chrome://tracing``."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    prof = profile(activities=acts, record_shapes=record_shapes)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}"
                                     ".pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"[profiling] trace written to {path}", flush=True)


def device_events(prof: torch.profiler.profile) -> list:
    """The profile's device events by name (``key_averages``): kernels,
    copies and sets, without user-annotation ranges."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy(prof: torch.profiler.profile, wall_ms: float
                ) -> tuple[float, float]:
    """(device busy ms, busy share of ``wall_ms`` in %) of a profile."""
    busy = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
    return busy, 100.0 * busy / max(wall_ms, 1e-9)


def _launching_op(event):
    """The innermost ``aten::`` op above a kernel's launch: the op that ran
    it, whose input shapes and dtypes the profile recorded."""
    e = event
    while e is not None:
        if e.name.startswith("aten::") and e.input_shapes:
            return e
        e = e.cpu_parent
    return None


def kernels_by_op(prof: torch.profiler.profile) -> list[dict]:
    """Device time of each kernel name by the op that launched it, with the
    op's input shapes and dtypes (a profile taken with
    ``record_shapes=True``), most time first: ``{"kernel", "op",
    "shapes", "dtypes", "ms", "count"}``."""
    rows: dict[tuple, dict] = {}
    for fe in prof.events():
        if fe.device_type != torch.autograd.DeviceType.CPU or not fe.kernels:
            continue
        op = _launching_op(fe)
        shapes = [list(s) for s in op.input_shapes] if op else []
        # input dtypes where this torch's profiler keeps them
        dtypes = list(getattr(op, "input_dtypes", None) or []) if op else []
        for k in fe.kernels:
            key = (k.name, op.name if op else fe.name, str(shapes),
                   str(dtypes))
            row = rows.setdefault(key, {
                "kernel": k.name, "op": key[1], "shapes": shapes,
                "dtypes": dtypes, "ms": 0.0, "count": 0})
            row["ms"] += k.duration / 1e3
            row["count"] += 1
    return sorted(rows.values(), key=lambda r: -r["ms"])


def enable_debug(nan_checks: bool = True) -> None:
    """Debug configuration: autograd's anomaly mode (a backward error names
    the forward op behind it), and with ``nan_checks`` its NaN check, under
    which the backward raises on the first function that returns a NaN and
    the train steps check their loss (:func:`check_finite`) before the
    backward.  Anomaly mode slows every step; it is a debug setting.
    ``dpc_tpu``'s ``disable_jit`` has no meaning in eager PyTorch and is
    not a parameter."""
    torch.autograd.set_detect_anomaly(True, check_nan=nan_checks)


def disable_debug() -> None:
    torch.autograd.set_detect_anomaly(False)


def nan_checks_on() -> bool:
    """Whether :func:`enable_debug` turned the NaN checks on."""
    return torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()


def check_finite(loss: torch.Tensor, what: str = "loss") -> None:
    """Raise ``FloatingPointError`` when ``loss`` holds a NaN or an Inf.
    Reads the value back from the card, so it waits for the step."""
    if not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"non-finite {what}: {loss.detach().cpu()}"
                                 " (--debug_nans)")


def synchronize(result) -> None:
    """Wait for the device work behind ``result`` (a tensor, or a dict,
    list or tuple of them): ``dpc_tpu``'s ``block_until_ready``; or for
    all work on ``result`` when it is a ``torch.device``."""
    if isinstance(result, torch.device):
        if result.type == "cuda":
            torch.cuda.synchronize(result)
    elif isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            synchronize(v)


class StepTimer:
    """Wall-clock step timing that waits for the device.

    Call ``tick(result)`` once per step with any tensor (or dict, list or
    tuple of them) from the step; the timer waits for its device, records
    the delta, and reports mean/p50/p99 and items/sec.
    """

    def __init__(self, items_per_step: int = 1, warmup: int = 2):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self.times: list[float] = []
        self._count = 0
        self._last: Optional[float] = None

    def tick(self, result=None) -> float:
        if result is not None:
            synchronize(result)
        now = time.perf_counter()
        dt = 0.0
        if self._last is not None:
            dt = now - self._last
            self._count += 1
            if self._count > self.warmup:
                self.times.append(dt)
        self._last = now
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "items_per_sec": float(self.items_per_step / arr.mean()),
        }
