"""The traffic generator: everything a run feeds the system, made from
``--seed`` and the traffic file's parameters.

A traffic file (``benchmark/traffic/<name>.json``) names the job and its
shapes: clips a rank (``batch``), ranks, the uint8 window the host half
of ``--device_augment`` hands the step (``window``: height, width), the
recipe, the number of distinct batches in the ring (``ring``), and for
the finetune job the label count.  The same seed gives the same windows,
labels, dropout and recipe draws, on every card; every batch of the ring
differs.  Seeds are folded with ``numpy.random.SeedSequence``, so any
whole number, however large, is a seed.
"""

from __future__ import annotations

import numpy as np
import torch


def fold(*values) -> int:
    """A 63-bit seed derived from ``values`` (whole numbers or strings)."""
    ints = [v if isinstance(v, int) else int.from_bytes(v.encode(), "little")
            for v in values]
    state = np.random.SeedSequence(ints).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def step_seeds(seed: int, rank: int, step: int) -> tuple[int, int]:
    """(dropout seed, recipe seed) of ``rank`` at ``step``."""
    return fold(seed, "dropout", rank, step), fold(seed, "recipe", rank, step)


def clip_shape(cfg: dict, traffic: dict) -> tuple[int, ...]:
    h, w = traffic["window"]
    return (traffic["batch"], cfg["num_seq"], cfg["seq_len"], h, w, 3)


def make_clips(seed: int, rank: int, j: int, cfg: dict, traffic: dict,
               device) -> torch.Tensor:
    """Batch ``j`` of ``rank``'s ring: uint8 windows made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        fold(seed, "clips", rank, j))
    return torch.randint(0, 256, clip_shape(cfg, traffic), generator=gen,
                         dtype=torch.uint8, device=device)


def make_labels(seed: int, rank: int, j: int, cfg: dict, traffic: dict,
                device) -> torch.Tensor | None:
    """The labels of batch ``j`` (finetune), or None."""
    if traffic["job"] != "finetune":
        return None
    gen = torch.Generator(device=device).manual_seed(
        fold(seed, "labels", rank, j))
    return torch.randint(0, cfg["finetune"]["num_classes"],
                         (traffic["batch"],), generator=gen, device=device)


def make_ring(seed: int, rank: int, cfg: dict, traffic: dict, device
              ) -> list:
    """The ring of host batches a rank's loop cycles through: pinned
    memory on a card, so the feed's copy runs on its side stream."""
    ring = []
    for j in range(traffic["ring"]):
        clips = make_clips(seed, rank, j, cfg, traffic, device)
        labels = make_labels(seed, rank, j, cfg, traffic, device)
        host = [clips, labels] if labels is not None else [clips]
        if device.type == "cuda":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True
                                ).copy_(t) for t in host]
        ring.append(tuple(host) if labels is not None else host[0])
        del clips, labels
    return ring


def inputs_of(seed: int, cfg: dict, traffic: dict, world: int, steps: int,
              device) -> tuple[list, list]:
    """What the reference takes for the first ``steps`` steps: per step,
    every rank's ``(clips, labels)`` on ``device`` and its seeds, made
    again from the seed."""
    inputs, seeds = [], []
    for s in range(steps):
        j = s % traffic["ring"]  # the ring batch the system's step s took
        inputs.append([(make_clips(seed, r, j, cfg, traffic, device),
                        make_labels(seed, r, j, cfg, traffic, device))
                       for r in range(world)])
        seeds.append([step_seeds(seed, r, s) for r in range(world)])
    return inputs, seeds
