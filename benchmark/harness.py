"""One run of a cell on one rank: set-up, the first steps that the
correctness check reads, warm-up, the measured window, with ``--trace 1``
a traced window and the pieces the per-layer metrics time, then the
reference.

The window drives the system's own epoch loop (``loop.run_epoch``, one
step deep) over a ring of distinct pinned uint8 batches, which the loop's
``DeviceFeed`` copies on its side stream; each step draws its dropout and
recipe from generators the benchmark seeds from ``--seed``, the rank and
the step, as the CLIs seed theirs.  A CUDA event after each step gives the
step times, read after the window, so nothing waits for the card inside
it.  On several ranks (``{data: n}``, started by the system's
``parallel.mesh.run_ranks``) rank 0's clock ends the window for all: the
ranks agree each step over the mesh's host group, so each runs as many
steps.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time

import torch

from benchmark import compare, feed, spec, tracing
from benchmark.reference import steps as reference
from benchmark.weights import make_weights
from dpc_tpu_torch.parallel import mesh as meshlib
from dpc_tpu_torch.train import loop
from dpc_tpu_torch.train.metrics import MetricBundle

CHECK_STEPS = 3
WARM_STEPS = 2
TRACE_SECONDS = 1.0
PIECE_REPS = 20
QUIET_PRINT = 1 << 62
BANNED = {"jax", "jaxlib", "flax", "dpc_tpu"}


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``BANNED`` (compared
    whole: ``dpc_tpu_torch`` is not ``dpc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


class RingLoader:
    """The ring's batches in turn, from step ``start`` on, until ``more()``
    says no (``run_epoch`` reads ``iterate`` and ``len``)."""

    def __init__(self, ring: list, more):
        self.ring, self.more = ring, more

    def __len__(self) -> int:
        return 0

    def iterate(self, start: int):
        idx = start
        while self.more():
            yield self.ring[idx % len(self.ring)]
            idx += 1


def _agree(mesh, value: int) -> int:
    """The largest of the ranks' ``value``s (this rank's alone on one)."""
    if mesh is None:
        return value
    t = torch.tensor([value])
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                 group=mesh.host_group)
    return int(t.item())


def _gather(mesh, obj) -> list:
    """Every rank's ``obj``, in rank order (on every rank)."""
    if mesh is None:
        return [obj]
    out = [None] * mesh.size
    torch.distributed.all_gather_object(out, obj, group=mesh.host_group)
    return out


def _for_seconds(mesh, seconds: float):
    end = time.monotonic() + seconds
    return lambda: not _agree(mesh, int(time.monotonic() >= end))


def _for_steps(n: int):
    left = [n]

    def more():
        left[0] -= 1
        return left[0] >= 0
    return more


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """A rank's system under test: the job (step, model, optimizer), the
    ring, the feed and the per-step generators."""

    def __init__(self, cell: spec.Cell, seed: int, rank: int, device, mesh):
        self.cell, self.seed, self.rank, self.device = cell, seed, rank, device
        self.mesh = mesh
        self.job = spec.job(cell.traffic["job"])(cell.config, cell.traffic,
                                                 device, mesh)
        weights = make_weights(cell.config, self.job.name, seed, device)
        self.job.load(weights)
        del weights
        self.ring = feed.make_ring(seed, rank, cell.config, cell.traffic,
                                   device)
        self.feed = loop.DeviceFeed(device)
        self.dropout = torch.Generator(device=device)
        self.recipe = torch.Generator()
        self.events: list | None = None

    def dispatch(self, idx: int, batch) -> dict:
        d, a = feed.step_seeds(self.seed, self.rank, idx)
        self.dropout.manual_seed(d)
        self.recipe.manual_seed(a)
        out = self.job.call(self.feed(batch), self.dropout, self.recipe)
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        return out

    def check_steps(self) -> dict:
        """The first steps, through the window's own call and feed: each
        step's metrics and the first step's embeddings (or logits); on
        rank 0 also its recipe output, the first gradient per leaf and
        each leaf's change over the steps."""
        first = self.rank == 0
        p0 = ({k: v.detach().cpu().clone() for k, v in
               self.job.params().items()} if first else None)
        got: dict = {"loss": [], "topk": []}
        for s in range(CHECK_STEPS):
            cap = self.job.capture(recipe=first) if s == 0 else \
                contextlib.nullcontext({})
            with cap as caught:
                m = loop.MetricsFetch(
                    self.dispatch(s, self.ring[s % len(self.ring)])).get()
            got.update(caught)
            got["loss"].append(m.pop("loss"))
            got["topk"].append(m)
            if first and s == 0:
                got["grads"] = self.job.first_gradients()
        got["embeds"] = _gather(self.mesh, got.pop("embed"))
        if first:
            got["delta_norms"] = {
                k: float((v.detach().cpu() - p0[k]).double().norm())
                for k, v in self.job.params().items()}
        return got

    def steps(self, start: int, more) -> int:
        return loop.run_epoch(self.dispatch, RingLoader(self.ring, more),
                              MetricBundle(), print_freq=QUIET_PRINT,
                              start_batch=start)

    def time_piece(self, fn) -> float:
        """CUDA-event ms of one call of ``fn``, the mean of a few after
        two warm-ups."""
        for _ in range(2):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(PIECE_REPS):
            fn()
        end.record()
        end.synchronize()
        self.job.optimizer.zero_grad(set_to_none=True)
        return start.elapsed_time(end) / PIECE_REPS


def rank_run(rank: int, params: dict) -> dict:
    """One run of the cell ``params['workload']`` on ``rank``: returns the
    window's timings, the trace's reduction, the pieces' times, on rank 0
    the correctness check, and last ``banned``, what of ``BANNED`` this
    rank's process has loaded by its end."""
    world = params["world"]
    cuda = params.get("device", "cuda") == "cuda"
    device = meshlib.rank_device("cuda" if cuda else "cpu", rank)
    torch.set_num_threads(1)
    mesh = meshlib.make_mesh(world) if world > 1 else None
    cell = spec.load(params["workload"], params["root"]) \
        if "cell" not in params else params["cell"]
    seed = params["seed"]
    run = Run(cell, seed, rank, device, mesh)
    got = run.check_steps()
    idx = CHECK_STEPS
    idx += run.steps(idx, _for_steps(WARM_STEPS))
    _sync(device)
    if cuda:
        run.events = [torch.cuda.Event(enable_timing=True)]
        run.events[0].record()
    t0 = time.monotonic()
    n = run.steps(idx, _for_seconds(mesh, params["seconds"]))
    _sync(device)
    t1 = time.monotonic()
    idx += n
    out = {"rank": rank, "t0": t0, "steps": n, "window_s": t1 - t0,
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if cuda else 0),
           "device_name": torch.cuda.get_device_name(device) if cuda
           else "cpu"}
    if cuda:
        ev = run.events
        out["step_ms"] = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    run.events = None
    if params["trace"] and cuda:
        k = _agree(mesh, max(3, math.ceil(TRACE_SECONDS * n / (t1 - t0))))
        out["trace"] = traced(run, idx, k)
        idx += k
        if rank == 0:
            batch = run.feed(run.ring[0])
            out["pieces"] = {p: run.time_piece(run.job.piece(
                p, batch, run.dropout, run.recipe)) for p in run.job.pieces}
            del batch
    job_name = run.job.name
    del run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank == 0:
        out["check"] = check(cell, job_name, seed, world, got, device)
    out["banned"] = banned_modules()
    return out


def traced(run: Run, idx: int, k: int) -> dict:
    """``k`` steps under ``torch.profiler``, reduced (``tracing``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            run.steps(idx, _for_steps(k))
            _sync(run.device)
    out = tracing.reduce(prof)
    out["steps"] = k
    return out


def check(cell: spec.Cell, job_name: str, seed: int, world: int, got: dict,
          device) -> dict:
    """The reference over the same weights and inputs, and the numbers
    against the cell's limits."""
    ref = reference_readings(cell, job_name, seed, world, device)
    nums, readings = compare.numbers(got, ref, job_name)
    return {"numbers": nums, "readings": readings,
            "correct": compare.judge(nums, cell.limits)}


def reference_readings(cell: spec.Cell, job_name: str, seed: int, world: int,
                       device, precision: str = "float32", fault=None
                       ) -> dict:
    """The reference's readings (``reference.steps.run``), with the first
    step's labels of every rank (the finetune job's; else None)."""
    weights = make_weights(cell.config, job_name, seed, device)
    inputs, seeds = feed.inputs_of(seed, cell.config, cell.traffic, world,
                                   CHECK_STEPS, device)
    out = reference.run(cell.config, job_name, weights, inputs, seeds,
                        device, precision, fault)
    out["labels"] = [labels for _, labels in inputs[0]]
    return out
