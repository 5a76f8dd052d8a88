"""The program's spans in a ``torch.profiler`` trace of the traced window.

``dpc_tpu_torch`` records named ranges (``dpc.*``, its
``utils.profiling.span``) in its step, epoch loop and feed while a
profiler records; ``torch.profiler`` puts them, the CUDA runtime calls
and CUPTI's device activity on one clock.  ``reduce`` reads, a step of the
window:

* a span's device ms: the device time of every kernel, copy and set whose
  launching runtime call lies inside the span's host interval, on the
  span's thread; for ``dpc.step.backward`` also on autograd's device
  threads, whose launches also count towards the main-thread spans around
  it.  Spans nest, so an outer span's device ms holds its inner spans';
* the stem's backward region: from the zero-length mark
  ``dpc.backbone.stem.backward`` (the stem's output gradient is complete)
  to the end of the step's backward, on the mark's thread;
* a span's host ms, its launches and its blocking runtime calls
  (``BLOCKING``), both by the innermost span they lie in, and the
  blocking calls and their host ms within each span;
* ``feed_exposed_ms``: the time in which a copy launched under
  ``dpc.feed.copy`` ran and no other device operation did;
* ``coverage``: the share of the compute stream's device time (the stream
  with the most of it) launched under the step's top-level spans
  (``STEP``);
* ``idle_s``: each idle gap of the device within the window (as
  ``tracing.reduce`` finds them), by the innermost span open on the main
  thread at its middle, else ``outside``, in seconds over the window.

The stem's readings assume the backbone is not checkpointed (``remat``
off, as in every cell): a recomputed forward records the stem's span a
second time, inside the backward.

Run as a script, it runs one cell of one rank as ``benchmark/run.py
--trace 1`` does, through ``harness.traced`` as it is, reduces the
window's events with ``reduce`` into the trace under ``spans`` (what
``harness.traced`` does once it calls it), and reports through
``run.report``, so that it refuses a run that loaded ``jax``, ``jaxlib``,
``flax`` or ``dpc_tpu`` as ``run.py`` does: the result line carries the
per-layer metrics that read the spans (``SPAN_METRICS``) beside the
cell's own, and a ``[trace]`` line on standard error follows it:

  python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

Once ``harness.traced`` merges ``reduce`` and ``BENCHMARK.json`` lists the
eight readers, ``main``, ``_keeping_events`` and ``SPAN_METRICS`` go.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import re
import sys
import time

import torch

from benchmark import peaks, tracing

T_START = time.monotonic()
CPU = torch.autograd.DeviceType.CPU
PREFIX = "dpc."
STEP = ("dpc.step.recipe", "dpc.step.forward", "dpc.step.loss",
        "dpc.step.backward", "dpc.step.optimizer", "dpc.step.allreduce")
BACKWARD = "dpc.step.backward"
STEM_MARK = "dpc.backbone.stem.backward"
FEED = "dpc.feed.copy"
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy"})
RUNTIME = re.compile(r"cu(da)?[A-Z]")
AUTOGRAD = "autograd::engine::evaluate_function"
OUTSIDE = "outside"
SPAN_METRICS = {"recipe_step_ms": "ms", "stem_step_roofline": "%",
                "convgru_step_roofline": "%", "nce_step_roofline": "%",
                "adam_step_ms": "ms", "feed_exposed_ms": "ms",
                "host_queue_ms": "ms", "host_syncs_per_step": "calls"}


class _Region:
    __slots__ = ("name", "start", "end", "thread")

    def __init__(self, name, start, end, thread):
        self.name, self.start, self.end = name, start, end
        self.thread = thread


class _Index:
    """The regions of one thread that contain a time."""

    def __init__(self, regions: list):
        self.regions = sorted(regions, key=lambda r: r.start)
        self.starts = [r.start for r in self.regions]
        self.longest = max((r.end - r.start for r in regions), default=0.0)

    def at(self, t: float) -> list:
        lo = bisect.bisect_left(self.starts, t - self.longest)
        hi = bisect.bisect_right(self.starts, t)
        return [r for r in self.regions[lo:hi] if t <= r.end]


def _union(intervals) -> list:
    return tracing._union([(s, e) for s, e in intervals if e > s])


def _minus(a: list, b: list) -> float:
    """The length of the union ``a`` less the union ``b``."""
    total, j = 0.0, 0
    for s, e in a:
        cut = s
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += max(0.0, min(b[k][0], e) - cut)
            cut = max(cut, b[k][1])
            k += 1
        total += max(0.0, e - cut)
    return total


def reduce(events, steps: int) -> dict:
    """The spans of the ``tracing.WINDOW`` range in ``events`` (a
    profile's ``events()``) over ``steps`` steps: ``{"window_ms",
    "spans": {name: {device_ms, host_ms, launches, syncs, syncs_within,
    sync_ms_within}}, "feed_exposed_ms", "coverage", "idle_s",
    "unlinked_ms"}``, every number a step except ``idle_s``."""
    host = [e for e in events if e.device_type == CPU]
    marks = [e for e in host if e.name == tracing.WINDOW]
    if not marks:
        raise RuntimeError("the trace holds no traced window")
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    main = marks[0].thread
    autograd = {e.thread for e in host if e.name.startswith(AUTOGRAD)}
    spans = [e for e in host if e.name.startswith(PREFIX)
             and w0 <= e.time_range.start <= w1]
    backward = sorted((e for e in spans if e.name == BACKWARD),
                      key=lambda e: e.time_range.start)
    bwd_starts = [e.time_range.start for e in backward]

    def backward_at(t):
        i = bisect.bisect_right(bwd_starts, t) - 1
        if i >= 0 and t <= backward[i].time_range.end:
            return backward[i]
        return None

    regions = []
    for s in spans:
        start, end = s.time_range.start, s.time_range.end
        if s.name == STEM_MARK:
            b = backward_at(start)
            if b is None:
                continue
            end = b.time_range.end
        regions.append(_Region(s.name, start, end, s.thread))
    index = {th: _Index([r for r in regions if r.thread == th])
             for th in {r.thread for r in regions}}
    none = _Index([])

    def containing(t, thread) -> list:
        found = index.get(thread, none).at(t)
        if thread in autograd:
            b = backward_at(t)
            if b is not None and b.thread != thread:
                found += [r for r in index[b.thread].at(b.time_range.start)
                          if b.time_range.end <= r.end]
        return found

    def innermost(found) -> str:
        return min(found, key=lambda r: r.end - r.start).name if found \
            else OUTSIDE

    names = sorted({r.name for r in regions})
    per = {n: {"device_ms": 0.0, "host_ms": 0.0, "launches": 0, "syncs": 0,
               "syncs_within": 0, "sync_ms_within": 0.0} for n in names}
    per[OUTSIDE] = {"device_ms": 0.0, "launches": 0, "syncs": 0}
    for r in regions:
        per[r.name]["host_ms"] += (r.end - r.start) / 1e3

    # a device operation and the runtime call that launched it share the
    # correlation id
    calls = {e.id: e for e in host if RUNTIME.match(e.name)}
    dev = tracing._device_events(events)
    streams: dict = {}
    launched: set = set()
    feed, other = [], []
    unlinked = 0.0
    for k in dev:
        dur = k.time_range.end - k.time_range.start
        call = calls.get(k.id)
        iv = (max(k.time_range.start, w0), min(k.time_range.end, w1))
        if call is None or not w0 <= call.time_range.start <= w1:
            other.append(iv)
            if call is None and w0 <= k.time_range.start <= w1:
                unlinked += dur
            continue
        found = containing(call.time_range.start, call.thread)
        for n in {r.name for r in found}:
            per[n]["device_ms"] += dur / 1e3
        if not found:
            per[OUTSIDE]["device_ms"] += dur / 1e3
        if id(call) not in launched:
            launched.add(id(call))
            per[innermost(found)]["launches"] += 1
        (feed if any(r.name == FEED for r in found) else other).append(iv)
        stream = getattr(k, "device_resource_id", 0)
        tot = streams.setdefault(stream, [0.0, 0.0])
        tot[0] += dur
        if any(r.name in STEP for r in found):
            tot[1] += dur
    for c in host:
        if c.name not in BLOCKING or not w0 <= c.time_range.start <= w1:
            continue
        found = containing(c.time_range.start, c.thread)
        per[innermost(found)]["syncs"] += 1
        for n in {r.name for r in found}:
            per[n]["syncs_within"] += 1
            per[n]["sync_ms_within"] += c.time_range.elapsed_us() / 1e3

    # idle gaps, named by the innermost span open on the main thread
    busy = _union((max(k.time_range.start, w0), min(k.time_range.end, w1))
                  for k in dev)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle: dict[str, float] = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            name = innermost(index.get(main, none).at(0.5 * (s + e)))
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6

    compute = max(streams.values(), key=lambda v: v[0], default=[0.0, 0.0])
    for v in per.values():
        for key in v:
            v[key] /= steps
    return {"window_ms": (w1 - w0) / 1e3 / steps, "spans": per,
            "feed_exposed_ms": _minus(_union(feed), _union(other))
            / 1e3 / steps,
            "coverage": 100.0 * compute[1] / compute[0] if compute[0]
            else None,
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "unlinked_ms": unlinked / 1e3 / steps}


def of(ctx):
    """Rank 0's span reduction (``trace.spans``), or None where the trace
    holds none (no trace, or a harness that does not reduce the spans)."""
    return (ctx["rank0"].get("trace") or {}).get("spans")


def device_ms(ctx, *names: str):
    """The summed device ms a step of ``names`` in rank 0's span
    reduction, or None where there is none or it lacks one of them."""
    spans = of(ctx)
    if not spans or any(n not in spans["spans"] for n in names):
        return None
    return sum(spans["spans"][n]["device_ms"] for n in names)


def share_of_roofline(flops: float, nbytes: float, ms):
    """The least time of the work over ``ms`` (None passes through)."""
    if not ms:
        return None
    return 100.0 * peaks.least_seconds(flops, nbytes) / (ms / 1e3)


def line(spans: dict) -> str:
    """The ``[trace]`` line: the window a step, the top-level spans'
    device ms a step, the coverage, each span's device ms, launches and
    blocking calls a step, the idle by span."""
    step = sum(spans["spans"][n]["device_ms"] for n in STEP
               if n in spans["spans"])
    parts = [f"window {spans['window_ms']:.3f} ms/step",
             f"step spans {step:.3f} ms",
             f"coverage {spans['coverage']:.2f}%" if spans["coverage"]
             is not None else "coverage none",
             f"feed exposed {spans['feed_exposed_ms']:.3f} ms",
             f"unlinked {spans['unlinked_ms']:.3f} ms"]
    for n, v in spans["spans"].items():
        parts.append(f"{n} {v['device_ms']:.3f} ms {v['launches']:.1f} "
                     f"launches {v['syncs']:.2f} syncs")
    idle = ", ".join(f"{n} {s:.6f}" for n, s in spans["idle_s"].items())
    return "[trace] " + "; ".join(parts) + f"; idle s: {idle}"


@contextlib.contextmanager
def _keeping_events():
    """``tracing.reduce``, which ``harness.traced`` calls on its profile,
    keeping the profile's events under ``"events"`` while open."""
    plain = tracing.reduce

    def keep(prof):
        out = plain(prof)
        out["events"] = prof.events()
        return out

    tracing.reduce = keep
    try:
        yield
    finally:
        tracing.reduce = plain


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    args = p.parse_args(argv)
    from benchmark import harness, run, spec

    cell = spec.load(args.workload)
    if cell.chips != 1 or not torch.cuda.is_available():
        print(f"cell {cell.name}: needs one CUDA card and a one-chip cell",
              file=sys.stderr)
        return 2
    with _keeping_events():
        results = [harness.rank_run(0, {
            "workload": args.workload, "root": spec.ROOT, "seed": args.seed,
            "seconds": args.seconds, "trace": True, "world": 1,
            "device": "cuda"})]
    trace = results[0]["trace"]
    trace["spans"] = reduce(trace.pop("events"), trace["steps"])
    cell = dataclasses.replace(cell, per_layer=cell.per_layer + [
        {"name": n, "unit": u} for n, u in SPAN_METRICS.items()])
    rc = run.report(cell, results, True, T_START)
    if rc == 0:
        print(line(trace["spans"]), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
