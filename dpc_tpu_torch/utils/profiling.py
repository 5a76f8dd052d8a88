"""Tracing, profiling and debug hooks (port of
``dpc_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` over the CPU and the card around a
  block, written as a Chrome trace (``--profile`` of the pretrain CLI);
* :func:`span` and :func:`mark_backward`: the program's named ranges
  (``dpc.*``) inside the step, the loop and the feed, recorded only while
  a profiler records, on the profiler's own clock beside the device's
  activity; with no profiler recording a span costs one flag check and
  the mark adds nothing to the autograd graph;
* :func:`enable_debug`: anomaly mode, which raises on the first NaN a
  backward function returns, and the finite-loss check the train step runs
  while it is on (``--debug_nans``);
* :func:`device_busy` and :func:`kernels_by_op`: how a profile is read.
  The busy share is defined here once: the union of the intervals in
  which a kernel, copy or set ran on any stream, without the GPU ranges of
  user annotations, over wall time, so a copy or NCCL stream overlapping
  the compute stream counts once and the share never passes 100%.

``dpc_tpu``'s ``enable_compilation_cache`` has no counterpart: it is JAX's
compilation cache; nor its ``StepTimer``, whose per-step wait for the card
would remove the overlap the epoch loop keeps.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

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


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the range ``name`` while a profiler
    records (``torch.profiler.record_function``), and is a shared no-op
    context otherwise.  The program's spans are named ``dpc.<layer>.<what>``
    (PERF.md §3 lists them with the metrics that read them)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def mark_backward(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, with a hook that records the zero-length range ``name`` when
    its gradient is complete in the backward, while a profiler records
    and ``x`` takes a gradient: the backward of what made ``x`` starts
    there.  The hook adds no node to the graph and changes no gradient;
    with no profiler recording nothing is registered."""
    if torch.autograd._profiler_enabled() and x.requires_grad:
        def hook(_grad):
            with torch.profiler.record_function(name):
                pass
        x.register_hook(hook)
    return x


def device_events(prof: torch.profiler.profile) -> list:
    """The profile's device events by name (``key_averages``): kernels,
    copies and sets, without user-annotation ranges."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy(prof: torch.profiler.profile, wall_ms: float
                ) -> tuple[float, float]:
    """(device busy ms, busy share of ``wall_ms`` in %) of a profile: the
    union of the intervals of its kernels, copies and sets over every
    stream."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)):
        if e > end:
            busy += e - max(s, end)
            end = e
    busy /= 1e3
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
