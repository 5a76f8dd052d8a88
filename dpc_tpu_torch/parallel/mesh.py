"""Ranks, process groups and the ('data', 'model') layout (port of
``dpc_tpu/parallel/mesh.py``).

One process per device.  ``dpc_tpu`` lays its devices out as a
``('data', 'model')`` grid in row-major order (``make_mesh``); here the
ranks are laid out the same way, rank ``r`` at ``(r // m, r % m)`` for a
model axis of ``m``, and each axis is a family of process groups: one
data group per model index (the ranks that share it) and one model group
per data index.  A collective over an axis is a collective over this
rank's group of that axis.  An axis of size 1 has no group (None), and
the collectives of ``parallel/collectives.py`` make no call on it, so a
one-rank run makes no collective call at all.

The backend is named by the caller: NCCL for ranks on distinct cards,
gloo for CPU tensors and for ranks that share one card (NCCL refuses
two ranks on one device).  ``run_ranks`` starts ranks from this process
(``torch.multiprocessing`` spawn, rendezvous on a file store);
``init_multihost`` joins ranks that torchrun started.

Random streams are ``torch.Generator``s seeded from integers:
``data_seed`` gives data shards distinct streams and model peers the same
one (``shard_key``), ``peer_rows`` slices this peer's part of draws made
for the whole data group (``peer_sample_keys``), and ``dropout_seed``
also decorrelates model peers, which hold different clips
(``dpc_tpu/train/pretrain_step.py:200-202``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import shutil
import signal
import tempfile
import threading
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(data, model)`` grid and its groups.

    ``world_group`` spans every rank (the gradient and metric means, the
    cross-replica BN); ``host_group`` is a gloo group over every rank for
    host-side agreement (the preemption flag, barriers), the world group
    itself when the backend is gloo.  Groups of size 1 are None."""

    n_data: int
    n_model: int
    rank: int
    data_group: Any = None
    model_group: Any = None
    world_group: Any = None
    host_group: Any = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(num_devices: int = 0, model_parallel: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over the ranks of the initialised
    process group (one rank, and no process group, for a one-device run).
    ``num_devices`` 0 means every rank; otherwise it must be the world
    size, since each rank drives one device.  Every rank must call this,
    in the same order as its other group creations."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    if num_devices and num_devices != world:
        raise ValueError(f"--num_devices {num_devices} but {world} ranks "
                         "run (one device a rank)")
    if world % model_parallel:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_parallel={model_parallel}")
    n_model = model_parallel
    n_data = world // n_model
    if not initialised:
        return Mesh(n_data, n_model, 0)
    rank, backend = dist.get_rank(), dist.get_backend()

    def group(ranks):
        # new_group is collective over the world: every rank creates every
        # group, and keeps its own
        g = dist.new_group(ranks, backend=backend, timeout=TIMEOUT)
        return g if rank in ranks else None

    data_groups = [group([d * n_model + m for d in range(n_data)])
                   if n_data > 1 else None for m in range(n_model)]
    model_groups = [group([d * n_model + m for m in range(n_model)])
                    if n_model > 1 else None for d in range(n_data)]
    world_group = dist.group.WORLD if world > 1 else None
    host_group = (world_group if backend == "gloo" or world == 1 else
                  dist.new_group(list(range(world)), backend="gloo",
                                 timeout=TIMEOUT))
    return Mesh(n_data, n_model, rank,
                data_group=data_groups[rank % n_model],
                model_group=model_groups[rank // n_model],
                world_group=world_group, host_group=host_group)


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's rows of a host batch holding the global batch: the
    ``mesh.size`` equal chunks of the leading axis in rank order, which is
    ``batch_sharding``'s row-major ``('data', 'model')`` split."""
    if mesh is None or mesh.size == 1:
        return batch
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch of {n} not divisible by {mesh.size} ranks")
    per = n // mesh.size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


def fold_seed(seed: int, *values: int) -> int:
    """A seed derived from ``seed`` and ``values`` (63 bits)."""
    state = np.random.SeedSequence((seed, *values)).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def data_seed(mesh: Optional[Mesh], seed: int) -> int:
    """The stream of this rank's data shard: distinct across data shards,
    the same on every model peer (``shard_key``).  Unchanged on a mesh
    with one data shard."""
    if mesh is None or mesh.n_data == 1:
        return seed
    return fold_seed(seed, mesh.data_index)


def dropout_seed(mesh: Optional[Mesh], seed: int) -> int:
    """The dropout stream of this rank: the data shard's, further folded
    with the model index when clips are sharded over the model axis, whose
    peers hold different clips."""
    seed = data_seed(mesh, seed)
    if mesh is None or mesh.n_model == 1:
        return seed
    return fold_seed(seed, 1, mesh.model_index)


def peer_rows(mesh: Optional[Mesh], n: int) -> tuple[int, int]:
    """``(rows to draw, this peer's first row)`` for per-sample draws of a
    rank holding ``n`` clips: the whole data group's ``n · m`` draws from
    the model-synced stream, of which this peer takes its ``n``, so every
    sample draws the same whether its data group runs on 1 or m peers
    (``peer_sample_keys``)."""
    if mesh is None or mesh.n_model == 1:
        return n, 0
    return n * mesh.n_model, n * mesh.model_index


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------

def rank_device(device_type: str, local_rank: int,
                same_card: bool = False) -> torch.device:
    """The device of a rank: ``cuda:<local rank>``, or ``cuda:0`` for
    ranks that share one card, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank found no card")
    index = 0 if same_card else local_rank
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local_rank} has no card: "
                           f"{torch.cuda.device_count()} visible")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _rank_entry(rank: int, world: int, store_path: str, backend: str,
                fn: Callable, args: tuple, results) -> None:
    """A spawned rank: join the process group, run ``fn(rank, *args)``,
    report its result (or its traceback) and leave the group."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{store_path}",
                                rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              backend: str = "gloo") -> list:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks of one process
    group (``backend``; rendezvous on a file store in a fresh temporary
    directory) and return their results in rank order.  ``fn`` must be
    importable (spawn pickles it by name) and its result picklable.  A
    rank that fails fails the run: the others are terminated, and this
    raises with the first failure's traceback.  Called from the main
    thread, a SIGTERM to this process is passed on to every rank (each
    rank's preemption guard then stops them all at one step)."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="dpc_ranks_")
    got: dict[int, Any] = {}
    failure = None

    def drain():
        nonlocal failure
        while not results.empty():
            rank, ok, value = results.get()
            if ok:
                got[rank] = value
            elif failure is None:
                failure = f"rank {rank} failed:\n{value}"

    try:
        procs = mp.start_processes(
            _rank_entry, args=(world, os.path.join(tmp, "store"), backend, fn,
                               tuple(args), results),
            nprocs=world, join=False, start_method="spawn")
        def pass_on(sig, _frame):
            for pid in procs.pids():
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, sig)

        forward = threading.current_thread() is threading.main_thread()
        if forward:
            previous = signal.signal(signal.SIGTERM, pass_on)
        try:
            while not procs.join(timeout=0.5):
                drain()
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            drain()
            raise RuntimeError(failure or str(e)) from None
        finally:
            if forward:
                signal.signal(signal.SIGTERM, previous)
        drain()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None or len(got) != world:
        raise RuntimeError(failure or f"{world - len(got)} ranks returned "
                           "no result")
    return [got[r] for r in range(world)]


def under_torchrun() -> bool:
    """True when torchrun (or another launcher with its environment)
    started this process as one rank of several."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_multihost(backend: str) -> tuple[int, int]:
    """Join the process group that torchrun set up (idempotent) and return
    ``(rank, world)``, the loader's ``(shard_id, num_shards)``.

    Without torchrun's ``RANK``/``WORLD_SIZE`` this is a genuine
    single-process run, ``(0, 1)``.  With them, a failure to join raises:
    nothing is caught, so a multi-host run never degrades into
    independent single-process runs that each train on shard 0 of 1."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not under_torchrun():
        return 0, 1
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()
