"""The ranks of a CLI run, shared by the pretrain and the finetune CLIs.

One rank a device (``parallel/mesh.py``).  ``--num_devices N`` starts N
ranks from the CLI's process (0: every visible card, one rank on the
CPU), NCCL on the cards and gloo with ``--device cpu``; under torchrun (or
with ``--multihost``, which reads torchrun's environment) each process is
one rank.  More ranks than cards, and a layout the steps refuse, exit with
the reason before any rank starts.  Rank 0 prints the run's lines; a rank
that fails fails the run; a rank's preemption exit becomes the run's.

    ranks.run(main, argv, args, device, check, body)

runs ``body(world)`` on every rank, where ``main(argv)`` is the CLI's
entry point (each spawned rank calls it again, inside the process group)
and ``check(n_data, n_model)`` raises ``ValueError`` for a layout the
CLI's steps refuse.
"""

from __future__ import annotations

import os
import sys
from typing import Callable

import torch
import torch.distributed as dist

from dpc_tpu_torch.parallel import mesh as meshlib


def backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _spawned_rank(rank: int, main: Callable, argv: list) -> str:
    """A rank that ``--num_devices`` started: the run, in a process group
    that ``mesh.run_ranks`` joined.  Returns the preemption exit's message,
    or "" when the run ended."""
    try:
        main(argv)
    except SystemExit as e:
        if e.code in (None, 0):
            return ""
        if isinstance(e.code, str) and e.code.startswith("[preemption]"):
            return e.code
        raise
    return ""


def count(args, device: torch.device) -> int:
    """How many ranks this run has: the process group's when there is one
    (spawned by ``--num_devices``, or torchrun's, joined here), else
    ``--num_devices`` (0: every visible card; one on the CPU), which this
    process then starts.  More ranks than cards is refused."""
    if args.multihost or meshlib.under_torchrun():
        meshlib.init_multihost(backend(device))
    if dist.is_initialized():
        world = dist.get_world_size()
        if args.num_devices and args.num_devices != world:
            raise SystemExit(f"--num_devices {args.num_devices} but the "
                             f"process group has {world} ranks")
        return world
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    world = args.num_devices or max(cards, 1)
    if device.type == "cuda" and world > cards:
        raise SystemExit(f"--num_devices {world} needs {world} cards, one "
                         f"rank a card; {cards} visible (ranks do not "
                         "share a card)")
    return world


def check_layout(batch_size: int, model_parallel: int, world: int,
                 check: Callable[[int, int], None]) -> None:
    """The divisibility rules of both CLIs (``dpc_tpu/train/evaluate.py:
    490-499``) and ``check``, the steps' own, before any rank starts: a
    bad layout exits with its reason."""
    if batch_size % world:
        raise SystemExit(f"--batch_size {batch_size} must be divisible by "
                         f"{world} devices")
    if world % model_parallel:
        raise SystemExit(f"{world} devices not divisible by "
                         f"--model_parallel {model_parallel}")
    try:
        check(world // model_parallel, model_parallel)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def run(main: Callable, argv: list, args, device: torch.device,
        check: Callable[[int, int], None],
        body: Callable[[int], None]) -> None:
    """Start the run's ranks, or be one: see the module docstring.
    ``args`` carries ``num_devices``, ``multihost``, ``batch_size`` and
    ``model_parallel``."""
    joined_here = not dist.is_initialized()
    world = count(args, device)
    check_layout(args.batch_size, args.model_parallel, world, check)
    if world > 1 and not dist.is_initialized():
        exits = [e for e in meshlib.run_ranks(_spawned_rank, world,
                                              (main, argv),
                                              backend=backend(device)) if e]
        if exits:
            raise SystemExit(exits[0])
        return
    rank = dist.get_rank() if dist.is_initialized() else 0
    stdout = sys.stdout
    if rank:  # rank 0 prints the run's lines
        sys.stdout = open(os.devnull, "w")
    try:
        body(world)
    finally:
        if rank:
            sys.stdout.close()
            sys.stdout = stdout
        if joined_here and dist.is_initialized():  # torchrun's group
            dist.destroy_process_group()


def mesh_and_device(device: torch.device, world: int, model_parallel: int
                    ) -> tuple[meshlib.Mesh, torch.device]:
    """This rank's mesh (of size 1, with no groups, for one rank) and
    device: ``cuda:<local rank>`` on the cards (torchrun's
    ``LOCAL_RANK``, else the rank)."""
    mesh = meshlib.make_mesh(world if world > 1 else 0, model_parallel)
    if world == 1:
        return mesh, device
    local = int(os.environ.get("LOCAL_RANK", mesh.rank))
    return mesh, meshlib.rank_device(device.type, local)
