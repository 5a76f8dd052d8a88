"""Benchmark: DPC pretrain train-step throughput on the card (port of the
repo's root ``bench.py``).

Prints ONE JSON line:
  {"metric": "clips/sec/gpu", "value": N, "unit": "clips/s",
   "vs_baseline": N, "windows": [...], "spread_pct": N, "host_load1": N,
   "ms_per_step": N, "peak_mem_mib": N, "device": "<name>, <power limit>"}

Baseline: the reference trains R18-128 K400 (~240k usable clips/epoch,
300 epochs) in >1 week on 4× P40 (README.md:68) ⇒ ~30 clips/sec/GPU.
``vs_baseline`` is the measured clips/sec divided by 30.

A "clip" is one training sample: num_seq=8 blocks × seq_len=5 frames at
128², the full forward, InfoNCE loss, backward and Adam update at the
flagship (R18, pred 3, batch 64, bf16 autocast, local negatives, the
ConvGRU and flash-NCE kernels), with weights from seed 0 and a
device-resident input from seed 1.  2 warm-up steps, then 5 windows of 20
steps; each window ends in ``torch.cuda.synchronize()`` after a step that
updated the parameters, so the backward and Adam are inside the number.
``value`` is the best window (contention only slows a window down); the
spread and the host's load say how quiet the host was.  The input feed is
measured apart (``python -m dpc_tpu_torch.train.bench_input``), and so is
the CLIs' epoch loop (``python -m dpc_tpu_torch.train.bench_loop``).

Runs on the card; ``--device cpu`` runs it on the CPU (the metric is then
named ``clips/sec/cpu``), and CUDA without a card raises.

Usage:
  python -m dpc_tpu_torch.bench
  python -m dpc_tpu_torch.bench --device cpu --img_dim 32 --batch_size 2 \
      --compute_dtype float32 --windows 2 --iters 1
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from dpc_tpu_torch.core.config import DPCConfig, TrainConfig, resolve_device
from dpc_tpu_torch.data.device_augment import device_augment_geometry
from dpc_tpu_torch.models import dpc
from dpc_tpu_torch.train import optim, pretrain_step
from dpc_tpu_torch.utils.profiling import synchronize

BASELINE_CLIPS_PER_S = 30.0


def flagship(device: torch.device, batch_size: int = 64, img_dim: int = 128,
             compute_dtype: str = "bfloat16", device_augment: bool = False,
             **shape):
    """The pretrain flagship every tool times: ``(cfg, tcfg, model,
    step)``, weights from seed 0.  ``gru_impl="pallas"`` as the pretrain
    CLI forces it; ``nce_impl="fused"``, the flash kernels of the flagship
    cell (the CLI's ``auto`` picks the materialised score at this shape on
    an 80 GB card, PERF.md §7).  ``shape``: other ``DPCConfig`` fields
    (8×5 blocks, pred 3 unless given)."""
    cfg = DPCConfig(img_dim=img_dim, compute_dtype=compute_dtype,
                    gru_impl="pallas", **shape)
    tcfg = TrainConfig(batch_size=batch_size, lr=1e-3, wd=1e-5,
                       negatives="local", nce_impl="fused",
                       device_augment=device_augment,
                       device_augment_recipe="crop_resize")
    model = dpc.build_dpc(cfg, device, seed=0)
    opt = optim.pretrain_optimizer(model, tcfg.lr, tcfg.wd)
    return cfg, tcfg, model, pretrain_step.make_pretrain_step(cfg, tcfg,
                                                               model, opt)


def flagship_batch(cfg: DPCConfig, tcfg: TrainConfig, seed: int = 1
                   ) -> np.ndarray:
    """One host batch of the shape the step takes, from ``seed``: uint8
    windows of the recipe's geometry under ``device_augment`` (the
    synthetic set's), f32 normal clips otherwise."""
    rng = np.random.default_rng(seed)
    if tcfg.device_augment:
        _, (wh, ww) = device_augment_geometry("synthetic", cfg.img_dim)
        return rng.integers(0, 256, (tcfg.batch_size, cfg.num_seq,
                                     cfg.seq_len, wh, ww, 3), np.uint8)
    return rng.standard_normal((tcfg.batch_size, cfg.num_seq, cfg.seq_len,
                                cfg.img_dim, cfg.img_dim, 3), np.float32)


def device_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them; 'cpu' off the
    card."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader",
                          f"--id={device.index or 0}"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pretrain step clips/s")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card fails")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--img_dim", default=128, type=int)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--windows", default=5, type=int)
    p.add_argument("--iters", default=20, type=int, help="steps a window")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg, tcfg, _, step = flagship(device, args.batch_size, args.img_dim,
                                  args.compute_dtype)
    x = torch.from_numpy(flagship_batch(cfg, tcfg)).to(device)
    gen = torch.Generator(device=device).manual_seed(2)  # GRU dropout
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):
        step(x, gen)
    synchronize(device)
    rates = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step(x, gen)
        synchronize(device)  # the last step's Adam update included
        rates.append(tcfg.batch_size * args.iters
                     / (time.perf_counter() - t0))
    rates.sort()
    best = rates[-1]
    try:
        load1 = round(os.getloadavg()[0], 2)
    except OSError:
        load1 = None
    result = {
        "metric": f"clips/sec/{'gpu' if device.type == 'cuda' else 'cpu'}",
        "value": round(best, 2),
        "unit": "clips/s",
        "vs_baseline": round(best / BASELINE_CLIPS_PER_S, 2),
        "windows": [round(r, 2) for r in rates],
        "spread_pct": round(100 * (rates[-1] - rates[0]) / rates[-1], 1),
        "host_load1": load1,
        "ms_per_step": round(1e3 * tcfg.batch_size / best, 3),
        "peak_mem_mib": (round(torch.cuda.max_memory_allocated(device)
                               / 2**20, 1)
                         if device.type == "cuda" else None),
        "device": device_name(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
