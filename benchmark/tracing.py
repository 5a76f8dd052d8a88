"""The reduction of a ``torch.profiler`` trace of the traced window to the
numbers the per-layer metrics and the result's ``breakdown`` read.

* busy: the union of the intervals in which any device operation ran
  (kernels, copies and sets, on every stream), clipped to the window, so
  the feed's copy stream and NCCL overlapping the compute stream count
  once;
* the device operations that took most time, by the op that launched them
  (the innermost ``aten::`` op above the launch, else the launch itself),
  over the profile, which holds the traced window and its last sync;
* the idle gaps of the device within the window, named by what the host
  was doing at their middle (the innermost host event there);
* the device time of NCCL's kernels.
"""

from __future__ import annotations

import bisect

import torch

WINDOW = "benchmark.traced_window"
TOP = 10


def _device_events(events) -> list:
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.time_range.end > e.time_range.start]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _launcher(event) -> str:
    e = event
    while e is not None:
        if e.name.startswith("aten::"):
            return e.name
        e = e.cpu_parent
    return event.name


def reduce(prof) -> dict:
    """``{window_s, busy_s, nccl_s, device_ops, idle_gaps}`` of the traced
    window (the ``WINDOW`` range the harness opens around it), times in
    seconds."""
    events = prof.events()
    marks = [e for e in events if e.name == WINDOW
             and e.device_type == torch.autograd.DeviceType.CPU]
    if not marks:
        raise RuntimeError("the trace holds no traced window")
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    dev = _device_events(events)
    clipped = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
               for e in dev]
    busy = _union([(s, e) for s, e in clipped if e > s])
    busy_us = sum(e - s for s, e in busy)
    nccl_us = sum(e - s for (s, e), ev in zip(clipped, dev)
                  if e > s and "nccl" in ev.name.lower())
    # device time by launching op and kernel: each launch on the host
    # carries its kernels' durations (the profile holds the window alone)
    ops: dict[str, float] = {}
    for fe in events:
        if fe.device_type == torch.autograd.DeviceType.CPU and fe.kernels:
            op = _launcher(fe)
            for k in fe.kernels:
                key = f"{op} > {k.name}"[:160]
                ops[key] = ops.get(key, 0.0) + k.duration
    # idle gaps named by the host's innermost event at their middle
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name != WINDOW and e.time_range.end > w0
                   and e.time_range.start < w1),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps: dict[str, float] = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        best = None
        for ev in host[max(0, i - 4000):i]:
            if ev.time_range.end >= mid and (
                    best is None or ev.time_range.elapsed_us()
                    < best.time_range.elapsed_us()):
                best = ev
        name = best.name[:160] if best is not None else "no host event"
        gaps[name] = gaps.get(name, 0.0) + (e - s)
    top = lambda d: [[k, v / 1e6] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "nccl_s": nccl_us / 1e6, "device_ops": top(ops),
            "idle_gaps": top(gaps)}
