"""Component-level timing breakdown of the DPC train step on the card (port
of ``dpc_tpu/train/bench_breakdown.py``).

Times each piece of the pretrain flagship step of ``dpc_tpu_torch.bench``
(R18-128, 8×5, pred 3, batch 64, bf16, the ConvGRU and flash-NCE kernels)
on its own: the full step; the backbone cut after the stem and pool, after
each layer, and whole, forward and forward+backward; the stem conv alone;
the head (GRU, rollout and NCE from precomputed features); and the model's
loss without the optimizer.  Each time is the mean of ``--iters`` calls
between two ``synchronize``s of the card, after one warm-up call.  The
stem is the production stem, the backbone's ``stem`` method: the fused
or the literal stem as ``stem_impl`` resolves.

``--profile PATH`` adds a ``torch.profiler`` record of two full steps with
the ops' input shapes: the table grouped by input shape, and each kernel's
device time by the op that launched it (``PATH``, ``PATH.json``, and the
top rows printed), which names the op behind a kernel by its shapes.

Runs on the card; ``--device cpu`` runs it on the CPU, and CUDA without a
card raises.  Usage:

    python -m dpc_tpu_torch.train.bench_breakdown [--profile PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import torch

from dpc_tpu_torch import bench
from dpc_tpu_torch.core.config import resolve_device
from dpc_tpu_torch.models import dpc
from dpc_tpu_torch.train import pretrain_step
from dpc_tpu_torch.utils import profiling

ITERS = 20


def timeit(fn: Callable, device: torch.device, iters: int = ITERS) -> float:
    """ms per call of ``fn``: one warm-up call, then ``iters`` calls
    between two synchronizes of the card."""
    fn()
    profiling.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    profiling.synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def _autocast(cfg, device):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=cfg.compute_dtype == "bfloat16")


def components(cfg, tcfg, model, step, x, gen) -> dict[str, Callable]:
    """The timed pieces, each a call without arguments: ``full_step``, the
    backbone prefixes ``{stem+pool,thru_l1,thru_l2,thru_l3,backbone}_
    {fwd,fwdbwd}``, ``stem_conv_fwd``, ``head_{fwd,fwdbwd}`` and
    ``model_{fwd,fwdbwd}``.  ``x``: the step's batch ``[B, N, SL, H, W,
    3]`` on the model's device; ``gen``: the GRU dropout's generator.  The
    ``*_fwd`` pieces return their output (``model_fwd`` and ``head_fwd``
    the loss), the ``*_fwdbwd`` ones their gradients."""
    device = x.device
    bb = model.backbone
    b, n = x.shape[:2]
    clips = x.reshape(b * n, *x.shape[2:])
    loss_fn = pretrain_step.make_nce_loss(cfg, tcfg, device)
    out: dict[str, Callable] = {"full_step": lambda: step(x, gen)}

    def prefix(n_stages: int) -> Callable:
        modules = [bb.conv1, bb.bn1] + [getattr(bb, f"layer{i + 1}")
                                        for i in range(n_stages)]
        params = [p for m in modules for p in m.parameters()]

        def f():
            h = bb.stem(clips.permute(0, 4, 1, 2, 3))
            for si in range(n_stages):
                h = getattr(bb, f"layer{si + 1}")(h)
            return h

        def fwd():
            with torch.no_grad(), _autocast(cfg, device):
                return f()

        def fwdbwd():
            with _autocast(cfg, device):
                loss = f().float().sum()
            return torch.autograd.grad(loss, params)

        return fwd, fwdbwd

    for n_stages, name in ((0, "stem+pool"), (1, "thru_l1"), (2, "thru_l2"),
                           (3, "thru_l3"), (4, "backbone")):
        out[f"{name}_fwd"], out[f"{name}_fwdbwd"] = prefix(n_stages)

    def stem_conv():
        with torch.no_grad(), _autocast(cfg, device):
            return bb.conv1(clips.permute(0, 4, 1, 2, 3))

    out["stem_conv_fwd"] = stem_conv

    # the head from precomputed features
    with torch.no_grad(), _autocast(cfg, device):
        feats = dpc.encode_blocks(model, x, cfg)
    head_params = [p for name in ("agg", "network_pred")
                   for p in getattr(model, name).parameters()]

    def head_loss(feature_pre):
        with _autocast(cfg, device):
            pred, gt = dpc.predict_from_features(model, feature_pre, cfg=cfg,
                                                 train=True, generator=gen)
        return loss_fn(pred, gt)[0]

    def head_fwd():
        with torch.no_grad():
            return head_loss(feats)

    def head_fwdbwd():
        f = feats.detach().requires_grad_(True)
        return torch.autograd.grad(head_loss(f), head_params + [f])

    out["head_fwd"], out["head_fwdbwd"] = head_fwd, head_fwdbwd

    # the loss through everything, no optimizer
    params = [p for p in model.parameters() if p.requires_grad]

    def model_loss():
        with _autocast(cfg, device):
            pred, gt = dpc.predict(model, x, cfg=cfg, train=True,
                                   generator=gen)
        return loss_fn(pred, gt)[0]

    def model_fwd():
        with torch.no_grad():
            return model_loss()

    out["model_fwd"] = model_fwd
    out["model_fwdbwd"] = lambda: torch.autograd.grad(model_loss(), params)
    return out


def profile_step(fn: Callable, device: torch.device, path: str) -> list:
    """torch.profiler with the ops' input shapes over two calls of ``fn``
    (after one warm-up): the table grouped by input shape and the kernels
    by launching op into ``path``, the rows into ``path + '.json'``, the
    busy share and the top rows printed.  Returns the rows."""
    fn()
    profiling.synchronize(device)
    with profiling.trace(os.path.dirname(os.path.abspath(path)),
                         record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            fn()
        profiling.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, busy_pct = profiling.device_busy(prof, wall_ms)
    rows = profiling.kernels_by_op(prof)
    summary = f"2 full steps: wall {wall_ms:.1f} ms" + (
        f", device busy {busy_ms:.1f} ms ({busy_pct:.1f}%)"
        if device.type == "cuda" else "")
    lines = [f"{r['ms'] / 2:9.3f} ms/step x{r['count'] / 2:g} "
             f"{r['kernel'][:110]} <- {r['op']} {r['shapes'][:3]}"
             + (f" {r['dtypes'][:3]}" if r["dtypes"] else "")
             for r in rows]
    with open(path, "w") as f:
        f.write(summary + "\n\nkernels by launching op (per step):\n"
                + "\n".join(lines) + "\n\n"
                + prof.key_averages(group_by_input_shape=True).table(
                    sort_by="self_cuda_time_total", row_limit=60) + "\n")
    with open(path + ".json", "w") as f:
        json.dump({"wall_ms": wall_ms, "steps": 2,
                   "busy_ms": busy_ms if device.type == "cuda" else None,
                   "rows": rows}, f)
    print(f"[profile] {summary}; table in {path}", flush=True)
    for line in lines[:15]:
        print(f"[profile] {line}", flush=True)
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train-step breakdown")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card fails")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--img_dim", default=128, type=int)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--iters", default=ITERS, type=int)
    p.add_argument("--profile", default="",
                   help="profile two full steps with the ops' shapes into "
                        "this file")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg, tcfg, model, step = bench.flagship(device, args.batch_size,
                                            args.img_dim, args.compute_dtype)
    x = torch.from_numpy(bench.flagship_batch(cfg, tcfg)).to(device)
    gen = torch.Generator(device=device).manual_seed(2)
    parts = components(cfg, tcfg, model, step, x, gen)
    if args.profile:
        profile_step(parts["full_step"], device, args.profile)
    results = {k: timeit(fn, device, args.iters) for k, fn in parts.items()}
    for k, v in results.items():
        print(f"{k:>20}: {v:8.2f} ms")
    print(json.dumps({k: round(v, 2) for k, v in results.items()}),
          flush=True)
    return results


if __name__ == "__main__":
    main()
