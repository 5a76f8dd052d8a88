"""Smoke run of dpc_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, and drives the DPC pretrain
step and the LC finetune, eval and dense-test path at their full width.

    python3 chip_smoke.py [--profile PATH]

Phases, each printing its facts before the next starts:
  1. build    compile csrc/*.cu for sm_90a (one nvcc per source, in
              parallel); count the tensor-core instructions (HGMMA, HMMA)
              in the SASS of the nce and convgru libraries
  2. kernels  K-GRU-F/B, K-NCE-F/B and the stem pool's K1/K2/K8 against
              their plain versions on the card, at the pretrain and LC
              shapes, the 6144-row NCE shape, R50's D=1024, a D that is
              not a multiple of 32, ragged shapes and data with exact ties,
              with f32 matmul and cuDNN TF32 off; values and grads; the
              stem activation's layout as the backbone makes it
  3. step     a small f32 step through the kernels against the same step
              through the plain paths; then the pretrain flagship R18-128,
              B=64, bf16 train step (gru_impl="pallas", nce_impl="fused",
              stem pool "auto"): 2 warm-up and 10 timed steps, with the
              kernels' launch counts read around the timed steps; then
              the same step with nce_impl="xla", and with gru_impl="scan"
              (the per-step plain recurrence), in turns with it
  4. lc       the same check for one small f32 LC finetune step; then the
              LC flagship R18-128, 8x5, B=32, bf16, 101 classes: 2 warm-up
              and 10 timed finetune steps with the launch counts read
              around them, the same step with gru_impl="scan" in turns
              with it, one eval step, and the dense-test forward at window
              batch 32
  5. cli      python -m dpc_tpu_torch.train.pretrain for 2 synthetic steps;
              python -m dpc_tpu_torch.train.evaluate for 1 epoch of 2 steps
              plus val, then --test random on a few synthetic videos
  6. frames   both CLIs on a UCF-shaped tree of 320x240 JPEGs written with
              the port's encoder (16 videos of 150 frames, 640 train
              rows): with the host recipe, the pretrain flagship for 2
              epochs of 2 steps with val, epoch and step checkpoints; a
              mid-epoch resume from a step file alone and an epoch
              resume, each step's loss within 1e-3 of the uninterrupted
              run's; the finetune CLI from that run and the dense test of
              the finetune run; the CLI's clips/s and device busy share in
              its second epoch, the loader alone in thread and process
              mode, and one thread's decode and augment times.  Then
              --device_augment: the device recipes on the card against
              the CPU, the dense-test recipe against the host transform,
              the ROI decode against the full decode, the stem fold on
              uint8 at the flagship stem shape; the pretrain
              flagship for 2 epochs of 10 steps (clips/s, busy share and
              nvJPEG's device time in the second), an epoch resume, the
              same 2 epochs with process workers, the finetune CLI and
              the dense test plain, five-crop and with
              the host recipe; the planned-decode fallbacks (0); the file
              reads, the loader alone with the host half, one thread's
              ROI decode, the H2D copy and its overlap, and the recipe's
              time
Then one JSON line of per-kernel results, the card's name and power limit,
and a last line {"ok": true, "device": {...}}.  Any failure exits non-zero
before the last line.  Without a CUDA device it exits 2 and prints no result.

--profile PATH writes torch.profiler tables of two pretrain and two LC
flagship steps, and the device time of each kernel inside K-GRU-F/B at the
pretrain and LC shapes, to PATH.  --rates ROOT only times the two flagship steps of
the dpc_tpu_torch under ROOT and prints one JSON line of clips/s: run it
for two checkouts in turns (a, b, b, a) in one call to compare commits.
--cli_rates RECIPE=ROOT (repeatable) only prints the pretrain CLI's clips/s
and busy share on a frame tree with RECIPE (device_augment or host), for
this checkout and the one under ROOT in turns (ROOT, here, here, ROOT).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM rate, dense f32 rate on the CUDA cores
# (the pool kernels), dense TF32 rate of the tensor cores (the NCE and GRU
# kernels, whose f32-accurate products take three TF32 passes).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12

TOL_VALUE = 1e-5   # max |kernel − plain| / max |plain|, forward values
TOL_GRAD = 1e-4    # the same for gradients (longer f32 reductions)
RANK_ROWS = 0.01   # share of rows whose rank may differ, by at most 2: a
                   # score within f32 rounding of pos flips a strict >
TOL_POOL_F32 = 1e-6  # max |kernel − plain| / max |plain| of the pool grads
                     # in f32: at most four terms summed, in the same order

# the kernels each path must launch (names of _build.LAUNCHES)
PRETRAIN_KERNELS = ("convgru_fwd", "convgru_bwd", "nce_fwd", "nce_bwd",
                    "maxpool_relu_fwd", "maxpool_relu_bwd")
LC_KERNELS = ("convgru_fwd", "convgru_bwd", "maxpool_relu_fwd",
              "maxpool_relu_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float,
             rate: float = F32_FLOPS) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Failed(Exception):
    pass


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
             / "cuobjdump"]
    try:
        import triton
        cands.append(Path(triton.__file__).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    except ImportError:
        pass
    for cand in cands:
        if cand.exists():
            return str(cand)
    raise Failed("cuobjdump not found (neither the CUDA toolkit's bin/ nor "
                 "triton/backends/nvidia/bin/): cannot show that the nce "
                 "and convgru libraries use the tensor cores")


def tensor_core_instructions(name: str) -> dict:
    """Counts of HGMMA (wgmma) and HMMA (mma.sync) in the SASS of library
    ``name``."""
    from dpc_tpu_torch.ops import _build

    sass = subprocess.run([_cuobjdump(), "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, timeout=300)
    expect(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
    return {op: len(re.findall(rf"\b{op}\b", sass.stdout))
            for op in ("HGMMA", "HMMA")}


def phase_build() -> None:
    from dpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    took = _build.build()
    log(f"[build] {', '.join(f'{k}.cu {v:.1f} s' for k, v in took.items())}"
        f"; total {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in _build.SOURCES:
        _build.library(name)
    for name in ("nce", "convgru"):
        tc = tensor_core_instructions(name)
        log(f"[build] {name} SASS tensor-core instructions: {tc}")
        expect(tc["HGMMA"] + tc["HMMA"] > 0,
               f"the {name} library holds no tensor-core instruction")


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def _gru_case(t, r, d, seed):
    import torch
    from dpc_tpu_torch.models import convgru
    from dpc_tpu_torch.models import layers as L
    from dpc_tpu_torch.ops import convgru_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        cell = convgru.ConvGRUCell(d, d, 1).to(dev)
    weights = tuple(w.detach().contiguous()
                    for w in convgru_cuda.pack_weights(cell))
    x = torch.randn(t, r, d, device=dev, generator=g).relu_()
    h0 = 0.5 * torch.randn(r, d, device=dev, generator=g)
    masks = L.dropout_mask((t, r, d), 0.1, g, dev)
    gout = torch.randn(t, r, d, device=dev, generator=g)
    return x, h0, weights, masks, gout


def _gru_library_fwd(x_seq, h0, weights, masks):
    """The per-step cuBLAS loop as a PyTorch user writes it: one addmm per
    gate group and step."""
    import torch

    wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o = weights
    wzr = torch.cat([wzr_x, wzr_h])
    ch = h0.shape[1]
    h, outs = h0, []
    for t in range(x_seq.shape[0]):
        zr = torch.sigmoid(torch.addmm(b_zr, torch.cat([x_seq[t], h], 1), wzr))
        z, r = zr[:, :ch], zr[:, ch:]
        o = torch.tanh(torch.addmm(b_o, x_seq[t], wo_x).addmm_(h * r, wo_h))
        h = torch.lerp(h, o, z).mul_(masks[t])
        outs.append(h)
    return torch.stack(outs)


def _profile_calls(fn, path: str, label: str) -> None:
    """torch.profiler over two calls of ``fn``: device time by kernel name,
    logged and appended to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in p.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    def short(key: str) -> str:
        key = key.replace("(anonymous namespace)::", "")
        return key.removeprefix("void ").split("(")[0].split("<")[0][:40]

    rows = [f"{short(e.key)} x{e.count // 2} "
            f"{e.self_device_time_total / 2e3:.4f} ms" for e in events]
    busy = sum(e.self_device_time_total for e in events) / 2e3
    log(f"[profile] {label}, per call: device {busy:.4f} ms; "
        + "; ".join(rows))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(f"{label}, per call: device {busy:.4f} ms\n"
                + "\n".join(rows) + "\n")


def check_gru(t, r, d, timed: bool, profile: str | None = None) -> dict:
    from dpc_tpu_torch.ops import convgru_cuda as G

    x, h0, w, m, gout = _gru_case(t, r, d, seed=r)
    out_k = G.convgru_forward(x, h0, w, m)
    out_p = G.convgru_forward_plain(x, h0, w, m)
    grads_k = G.convgru_backward(x, h0, out_k, w, m, gout)
    grads_p = G.convgru_backward_plain(x, h0, out_p, w, m, gout)
    names = ("dx", "dh0", "dwzr_x", "dwzr_h", "db_zr", "dwo_x", "dwo_h",
             "db_o")
    errs = {"out": rel_err(out_k, out_p)}
    errs.update({n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)})
    abs_f = float((out_k - out_p).abs().max())
    abs_b = max(float((a - b).abs().max()) for a, b in zip(grads_k, grads_p))
    log(f"[kernels] GRU T={t} R={r} D={d}: rel err "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    expect(errs["out"] <= TOL_VALUE, f"K-GRU-F disagrees at R={r}: {errs}")
    expect(all(v <= TOL_GRAD for k, v in errs.items() if k != "out"),
           f"K-GRU-B disagrees at R={r}: {errs}")
    res = {"fwd_err": abs_f, "bwd_err": abs_b}
    if timed:
        # bound: the FLOPs as three TF32 passes on the tensor cores (the
        # backward recomputes the gates: 3 × the forward's); the f32
        # CUDA-core bound is printed beside it
        wbytes = sum(p.numel() for p in w) * 4
        fwd_bytes, fwd_ops = 4 * (3 * t * r * d + r * d) + wbytes, \
            2 * t * r * 3 * d * (2 * d)
        bwd_bytes, bwd_ops = 4 * (5 * t * r * d + 2 * r * d) + 2 * wbytes, \
            3 * fwd_ops
        res["fwd"] = dict(
            ms=cuda_ms(lambda: G.convgru_forward(x, h0, w, m)),
            plain_ms=cuda_ms(lambda: G.convgru_forward_plain(x, h0, w, m)),
            library_ms=cuda_ms(lambda: _gru_library_fwd(x, h0, w, m)),
            bound=bound_ms(fwd_bytes, 3 * fwd_ops, TF32_FLOPS))
        res["bwd"] = dict(
            ms=cuda_ms(lambda: G.convgru_backward(x, h0, out_k, w, m, gout)),
            plain_ms=cuda_ms(lambda: G.convgru_backward_plain(
                x, h0, out_p, w, m, gout)),
            library_ms=None,
            bound=bound_ms(bwd_bytes, 3 * bwd_ops, TF32_FLOPS))
        log(f"[kernels] GRU T={t} R={r} D={d}: fwd {res['fwd']['ms']:.3f} ms "
            f"(plain {res['fwd']['plain_ms']:.3f}, cuBLAS loop "
            f"{res['fwd']['library_ms']:.3f}, bound "
            f"{res['fwd']['bound'][0]:.3f} 3xTF32, "
            f"{bound_ms(fwd_bytes, fwd_ops)[0]:.3f} f32); bwd "
            f"{res['bwd']['ms']:.3f} ms (plain {res['bwd']['plain_ms']:.3f}, "
            f"bound {res['bwd']['bound'][0]:.3f} 3xTF32, "
            f"{bound_ms(bwd_bytes, bwd_ops)[0]:.3f} f32)")
        if profile:
            _profile_calls(lambda: G.convgru_forward(x, h0, w, m), profile,
                           f"K-GRU-F T={t} R={r} D={d}")
            _profile_calls(
                lambda: G.convgru_backward(x, h0, out_k, w, m, gout),
                profile, f"K-GRU-B T={t} R={r} D={d}")
    return res


def check_nce(r, c, d, shift, timed: bool) -> dict:
    import torch
    from dpc_tpu_torch.ops import nce_cuda as N

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(r + c)
    rows = 0.25 * torch.randn(r, d, device=dev, generator=g)
    cols = 0.25 * torch.randn(c, d, device=dev, generator=g)
    targets = ((torch.arange(r, device=dev) + shift) % c).int()
    pos = (rows * cols[targets.long()]).sum(-1)
    gl = torch.randn(r, device=dev, generator=g) / r
    lse_k, rank_k = N.nce_forward(rows, cols, pos, targets)
    lse_p, rank_p = N.nce_forward_plain(rows, cols, pos, targets)
    dr_k, dc_k = N.nce_backward(rows, cols, lse_p, gl)
    dr_p, dc_p = N.nce_backward_plain(rows, cols, lse_p, gl)
    rank_diff = (rank_k - rank_p).abs()
    errs = {"lse": rel_err(lse_k, lse_p), "drows": rel_err(dr_k, dr_p),
            "dcols": rel_err(dc_k, dc_p)}
    n_rank = int((rank_diff > 0).sum())
    log(f"[kernels] NCE R={r} C={c} D={d}: rel err "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; rank differs on {n_rank} rows (max {float(rank_diff.max()):.0f})")
    expect(errs["lse"] <= TOL_VALUE, f"K-NCE-F lse disagrees: {errs}")
    expect(n_rank <= RANK_ROWS * r and float(rank_diff.max()) <= 2,
           f"K-NCE-F rank disagrees on {n_rank} rows")
    expect(errs["drows"] <= TOL_GRAD and errs["dcols"] <= TOL_GRAD,
           f"K-NCE-B disagrees: {errs}")
    res = {"fwd_err": float((lse_k - lse_p).abs().max()),
           "bwd_err": max(float((dr_k - dr_p).abs().max()),
                          float((dc_k - dc_p).abs().max()))}
    if timed:
        def library():
            return torch.logsumexp(rows @ cols.t(), dim=-1)

        # bound: the FLOPs the function needs, as three TF32 passes on the
        # tensor cores; the f32 CUDA-core bound is printed beside it
        fwd_bytes, fwd_ops = 4 * ((r + c) * d + 4 * r), 2 * r * c * d
        bwd_bytes, bwd_ops = 4 * (2 * (r + c) * d + 2 * r), 6 * r * c * d
        res["fwd"] = dict(
            ms=cuda_ms(lambda: N.nce_forward(rows, cols, pos, targets)),
            plain_ms=cuda_ms(lambda: N.nce_forward_plain(rows, cols, pos,
                                                         targets)),
            library_ms=cuda_ms(library),
            bound=bound_ms(fwd_bytes, 3 * fwd_ops, TF32_FLOPS))
        res["bwd"] = dict(
            ms=cuda_ms(lambda: N.nce_backward(rows, cols, lse_p, gl)),
            plain_ms=cuda_ms(lambda: N.nce_backward_plain(rows, cols, lse_p,
                                                          gl)),
            library_ms=None,
            bound=bound_ms(bwd_bytes, 3 * bwd_ops, TF32_FLOPS))
        log(f"[kernels] NCE R={r} C={c} D={d}: fwd {res['fwd']['ms']:.3f} ms "
            f"(plain {res['fwd']['plain_ms']:.3f}, matmul+logsumexp "
            f"{res['fwd']['library_ms']:.3f}, bound "
            f"{res['fwd']['bound'][0]:.3f} 3xTF32, "
            f"{bound_ms(fwd_bytes, fwd_ops)[0]:.3f} f32); bwd "
            f"{res['bwd']['ms']:.3f} ms (plain {res['bwd']['plain_ms']:.3f}, "
            f"bound {res['bwd']['bound'][0]:.3f} 3xTF32, "
            f"{bound_ms(bwd_bytes, bwd_ops)[0]:.3f} f32)")
    return res


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def _aten_pool(z4, relu: bool, gout=None):
    """ATen's max-pool of z4 [M, H, W, C] as the backbone calls it (an
    NCDHW channels-last-3d view), and with ``gout`` its autograd dz."""
    import torch
    import torch.nn.functional as F

    x = z4.detach().unsqueeze(1).permute(0, 4, 1, 2, 3).requires_grad_(
        gout is not None)
    y = F.max_pool3d(F.relu(x) if relu else x, (1, 3, 3), (1, 2, 2),
                     (0, 1, 1))
    if gout is None:
        return y
    y.backward(gout.unsqueeze(1).permute(0, 4, 1, 2, 3))
    return x.grad.permute(0, 2, 3, 4, 1)[:, 0]


def _pool_input(shape, dtype, ties: bool, seed: int):
    """Normal draws; with ``ties`` rounded to a grid of 0.5, so windows
    hold exact ties (and exact zeros)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(shape, device=dev, generator=g)
    if ties:
        z = (2 * z).round() / 2
    gout = torch.randn((shape[0], shape[1] // 2, shape[2] // 2, shape[3]),
                       device=dev, generator=g)
    return z.to(dtype), gout.to(dtype)


def _grad_err(name, got, want, dtype) -> float:
    """Holds a pool gradient: f32 to TOL_POOL_F32 relative, bf16 to one
    bf16 ulp of max |want|.  Returns the max abs error."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    peak = float(want.float().abs().max())
    if dtype == torch.float32:
        ok = err <= TOL_POOL_F32 * max(peak, 1e-30)
    else:
        ok = err <= _bf16_ulp(peak)
    expect(ok, f"{name} disagrees with its plain version: max abs err "
               f"{err:.3e}, max |dz| {peak:.3e}")
    return err


def check_pool(shape, dtype, ties: bool, timed: bool) -> dict:
    """K1, K2 and K8 against their plain versions at z ``shape``; K1 bit
    for bit.  On tie data K2 must route as ATen does (first max) and K8
    must give every tied max the window's gradient."""
    import torch
    from dpc_tpu_torch.ops import maxpool_cuda as P

    z, gout = _pool_input(shape, dtype, ties, seed=sum(shape))
    out_k, code_k = P.maxpool_relu_fwd(z)
    out_p, code_p = P.maxpool_relu_fwd_plain(z)
    expect(torch.equal(out_k, out_p) and torch.equal(code_k, code_p),
           f"K1 differs from its plain version at {shape} {dtype}: "
           f"{int((out_k != out_p).sum())} values, "
           f"{int((code_k != code_p).sum())} codes")
    dz_k = P.maxpool_relu_bwd(gout, code_k)
    dz_p = P.maxpool_relu_bwd_plain(gout, code_p)
    eq_k = P.maxpool_bwd_eq(z, gout)
    eq_p = P.maxpool_bwd_eq_plain(z, gout)
    torch.cuda.synchronize()
    res = {"fwd": {"err": 0.0},
           "bwd": {"err": _grad_err("K2", dz_k, dz_p, dtype)},
           "eq": {"err": _grad_err("K8", eq_k, eq_p, dtype)}}
    name = (f"pool {list(shape)} {str(dtype).split('.')[-1]}"
            + (" ties" if ties else ""))
    facts = [f"K1 bit-equal ({int((code_k == P.DEAD).sum())} dead codes)",
             f"K2 err {res['bwd']['err']:.2e}", f"K8 err {res['eq']['err']:.2e}"]
    if z.numel() <= 2 ** 24:
        # first-max routing against ATen, in f32 on the same values (at a
        # size where normal f32 draws hold no tied window maxima)
        dz_aten = _aten_pool(z.float(), True, gout.float())
        _grad_err("K2 vs ATen", dz_k, dz_aten, dtype)
        if dtype == torch.float32 and not ties:
            # bf16 draws tie within a window, where K8 gives every tied max
            # the gradient and ATen only the first
            _grad_err("K8 vs ATen", eq_k, _aten_pool(z.float(), False,
                                                     gout.float()), dtype)
        facts.append("K2 routes as ATen")
    if ties:
        # every tied max: K8 sends gradient where ATen's pool (no ReLU)
        # does not
        dz_first = _aten_pool(z.float(), False, gout.float())
        extra = int(((eq_k.float() != 0) & (dz_first == 0)).sum())
        expect(extra > 0, "tie data gave K8 no tied maxima")
        facts.append(f"K8 routes to {extra} tied maxima ATen skips")
    log(f"[kernels] {name}: " + "; ".join(facts))
    if timed:
        nz, no = z.numel() * z.element_size(), out_k.numel() * z.element_size()
        nc = code_k.numel()
        ops = 9 * out_k.numel()                   # compares per window
        zr = z.unsqueeze(1).permute(0, 4, 1, 2, 3).relu()
        _, idx = torch.ops.aten.max_pool3d_with_indices(
            zr, [1, 3, 3], [1, 2, 2], [0, 1, 1], [1, 1, 1], False)
        g5 = gout.unsqueeze(1).permute(0, 4, 1, 2, 3)
        res["fwd"].update(
            ms=cuda_ms(lambda: P.maxpool_relu_fwd(z)),
            plain_ms=cuda_ms(lambda: P.maxpool_relu_fwd_plain(z)),
            library_ms=cuda_ms(lambda: _aten_pool(z, True)),
            bound=bound_ms(nz + no + nc, ops))
        res["bwd"].update(
            ms=cuda_ms(lambda: P.maxpool_relu_bwd(gout, code_k)),
            plain_ms=cuda_ms(lambda: P.maxpool_relu_bwd_plain(gout, code_k)),
            library_ms=cuda_ms(
                lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                    g5, zr, [1, 3, 3], [1, 2, 2], [0, 1, 1], [1, 1, 1], False,
                    idx)),
            bound=bound_ms(no + nc + nz, 4 * z.numel()))
        res["eq"].update(
            ms=cuda_ms(lambda: P.maxpool_bwd_eq(z, gout)),
            plain_ms=cuda_ms(lambda: P.maxpool_bwd_eq_plain(z, gout)),
            library_ms=None,
            bound=bound_ms(nz + no + nz, 9 * 2 * z.numel()))
        del zr, idx
        for k, label in (("fwd", "K1"), ("bwd", "K2"), ("eq", "K8")):
            t = res[k]
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.3f}")
            log(f"[kernels] {name}: {label} {t['ms']:.3f} ms (plain "
                f"{t['plain_ms']:.3f}, ATen {lib}, bound "
                f"{t['bound'][0]:.3f} by {t['bound'][1]})")
    return res


def probe_stem_layout() -> None:
    """The stem activation and the gradient reaching the pool, as the LC
    backbone makes them under bf16 autocast."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig
    from dpc_tpu_torch.models import layers as L, lc

    dev = torch.device("cuda")
    bb = lc.build_lc(DPCConfig(compute_dtype="bfloat16"), 101, dev).backbone
    x = torch.randn(2, 5, 128, 128, 3, device=dev)
    seen = []
    with torch.autocast("cuda", dtype=torch.bfloat16):
        a = bb.bn1(bb.conv1(x.permute(0, 4, 1, 2, 3)))
        p = L.relu_maxpool_stem(a, "xla")
        p.register_hook(lambda g: seen.append(g))
        y = p
        for si in range(4):
            y = getattr(bb, f"layer{si + 1}")(y)
    y.float().sum().backward()
    cl = torch.channels_last_3d
    log(f"[kernels] stem activation {list(a.shape)} {a.dtype} strides "
        f"{a.stride()} channels_last_3d {a.is_contiguous(memory_format=cl)}; "
        f"grad at the pool output strides {seen[0].stride()} "
        f"channels_last_3d {seen[0].is_contiguous(memory_format=cl)}")
    expect(a.is_contiguous(memory_format=cl),
           "the stem activation is not channels_last_3d")


def phase_kernels(profile: str | None = None) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    try:
        check_gru(5, 1024, 256, timed=True, profile=profile)  # pretrain
        gru_lc = check_gru(8, 512, 256, timed=True, profile=profile)  # LC
        check_gru(5, 2156, 256, timed=False)           # ragged: 44 clips at 7²
        check_gru(5, 256, 1024, timed=True)            # R50's D
        check_gru(5, 300, 200, timed=False)            # D % 32 != 0, ragged R
        nce = check_nce(3072, 3072, 256, 0, timed=True)  # flagship
        check_nce(6144, 6144, 256, 0, timed=True)      # batch 128
        check_nce(1536, 1536, 1024, 0, timed=True)     # R50's D
        check_nce(640, 640, 200, 3, timed=False)       # D % 32 != 0
        check_nce(1000, 1500, 256, 37, timed=False)    # ragged
        pool = check_pool((1280, 64, 64, 64), bf16, False, timed=True)  # LC
        for dt in (bf16, f32):                         # pretrain
            check_pool((2560, 64, 64, 64), dt, False, timed=True)
        check_pool((1280, 64, 64, 64), f32, False, timed=False)
        for dt in (bf16, f32):
            check_pool((37, 18, 22, 64), dt, False, timed=False)  # ragged
            check_pool((64, 64, 64, 64), dt, True, timed=False)   # ties
        probe_stem_layout()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    return {"gru_lc": gru_lc, "nce": nce, "pool": pool}


# ---------------------------------------------------------------------------
# 3. the train step
# ---------------------------------------------------------------------------

def _small_step_check() -> None:
    """One f32 step at a small size through the kernels and through the
    plain paths (scan GRU, materialised score, ATen stem pool), same weights
    and batch: the losses must agree."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
    from dpc_tpu_torch.models import dpc
    from dpc_tpu_torch.train import optim, pretrain_step

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = torch.randn(4, 4, 5, 64, 64, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        losses = {}
        for gru_impl, nce_impl, stem in (("pallas", "fused", "pallas"),
                                         ("scan", "xla", "xla")):
            cfg = DPCConfig(img_dim=64, num_seq=4, seq_len=5, pred_step=2,
                            gru_impl=gru_impl, gru_dropout=0.0)
            model = dpc.build_dpc(cfg, dev, seed=0)
            model.backbone.stem_pool_impl = stem
            tcfg = TrainConfig(batch_size=4, nce_impl=nce_impl)
            step = pretrain_step.make_pretrain_step(
                cfg, tcfg, model, optim.pretrain_optimizer(model, 1e-3, 1e-5))
            losses[gru_impl] = float(step(x)["loss"])
        err = abs(losses["pallas"] - losses["scan"]) / abs(losses["scan"])
        log(f"[step] small f32 check: kernel path loss {losses['pallas']}, "
            f"plain path {losses['scan']}, rel diff {err:.2e}")
        expect(err <= 1e-4, f"kernel path and plain path disagree: {losses}")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _profile(fn, path: str | None, label: str) -> None:
    """torch.profiler over two calls of ``fn``: device busy share and the
    stem pool's share of device time, and the table appended to ``path``."""
    if not path:
        return
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t1 = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    events = [e for e in p.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    pool_ms = sum(e.self_device_time_total for e in events
                  if "pool" in e.key.lower()) / 1e3
    summary = (f"{label}, 2 steps: wall {wall_ms:.1f} ms, device busy "
               f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), stem "
               f"pool kernels {pool_ms:.1f} ms "
               f"({100 * pool_ms / max(busy_ms, 1e-9):.1f}% of busy)")
    table = p.key_averages().table(sort_by="self_cuda_time_total",
                                   row_limit=60)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(summary + "\n" + table + "\n")
    log(f"[profile] {summary}; table in {path}")


def _read_launches(what: str, n_steps: int, kernels) -> dict:
    """The launch counts since the last reset; each kernel of the path must
    have launched once per step."""
    from dpc_tpu_torch.ops import _build

    launches = dict(_build.LAUNCHES)
    log(f"[{what}] launches over {n_steps} steps: {launches}")
    expect(all(launches[k] == n_steps for k in kernels),
           f"a kernel of the {what} path did not launch once per step: "
           f"{launches}")
    return launches


def _pretrain_flagship():
    """The pretrain flagship's config, model, step and device batch."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
    from dpc_tpu_torch.models import dpc
    from dpc_tpu_torch.train import optim, pretrain_step

    dev = torch.device("cuda")
    cfg = DPCConfig(compute_dtype="bfloat16", gru_impl="pallas")
    tcfg = TrainConfig(batch_size=64, lr=1e-3, wd=1e-5, nce_impl="fused")
    model = dpc.build_dpc(cfg, dev, seed=0)
    step = pretrain_step.make_pretrain_step(
        cfg, tcfg, model, optim.pretrain_optimizer(model, tcfg.lr, tcfg.wd))
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(tcfg.batch_size, cfg.num_seq, cfg.seq_len, cfg.img_dim,
                    cfg.img_dim, 3, device=dev, generator=gen)
    return cfg, tcfg, model, step, x, gen


def phase_step(profile: str | None) -> dict:
    import torch
    from dpc_tpu_torch.ops import _build

    _small_step_check()
    cfg, tcfg, model, step, x, gen = _pretrain_flagship()
    batch = tcfg.batch_size
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(x, gen)
    torch.cuda.synchronize()

    n_steps = 10
    _build.reset_launches()
    t0 = time.perf_counter()
    metrics = [step(x, gen) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_launches("step", n_steps, PRETRAIN_KERNELS)
    losses = [float(m["loss"]) for m in metrics]
    top1 = [float(m["top1"]) for m in metrics]
    log(f"[step] R18-128 B={batch} bf16 gru=pallas nce=fused stem=auto: "
        f"{n_steps * batch / dt:.2f} clips/s ({1e3 * dt / n_steps:.1f} ms/step,"
        f" peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    log(f"[step] losses {losses}")
    log(f"[step] top1 {top1}")
    expect(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    _profile(lambda: step(x, gen), profile, "pretrain R18-128 B=64 bf16")
    _compare_paths(cfg, tcfg, model, step, x, gen)
    return {"launches": launches, "clips_per_s": n_steps * batch / dt}


def _in_turns(plain, kernel, batch: int, n: int = 5) -> dict:
    """clips/s of two step functions in turns (plain, kernel, kernel,
    plain; n steps each), after two warm-up steps of each."""
    import torch

    for fn in (plain, plain, kernel, kernel):
        fn()
    rates = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = plain if name == "plain" else kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        rates[name].append(n * batch / (time.perf_counter() - t0))
    return rates


def _compare_paths(cfg, tcfg, model, fused_step, x, gen) -> None:
    """The flagship step with the materialised score (nce_impl="xla"), and
    with the per-step plain recurrence (gru_impl="scan"), each against the
    kernels in turns: for the card's nce_impl="auto" rule and gru_impl
    default."""
    from dpc_tpu_torch.train import optim, pretrain_step

    def other(c, t):
        return pretrain_step.make_pretrain_step(
            c, t, model, optim.pretrain_optimizer(model, tcfg.lr, tcfg.wd))

    kernel = lambda: fused_step(x, gen)
    xla_step = other(cfg, dataclasses.replace(tcfg, nce_impl="xla"))
    rates = _in_turns(lambda: xla_step(x, gen), kernel, x.shape[0])
    log(f"[step] NCE path in turns: fused {rates['kernel']} clips/s, xla "
        f"(materialised score) {rates['plain']} clips/s")
    scan_step = other(dataclasses.replace(cfg, gru_impl="scan"), tcfg)
    rates = _in_turns(lambda: scan_step(x, gen), kernel, x.shape[0])
    log(f"[step] GRU path in turns: pallas (kernels) {rates['kernel']} "
        f"clips/s, scan (plain recurrence) {rates['plain']} clips/s")


# ---------------------------------------------------------------------------
# 4. the LC finetune, eval and dense-test path
# ---------------------------------------------------------------------------

def _lc_parts(cfg, ecfg, seed: int = 0):
    import torch
    from dpc_tpu_torch.models import lc
    from dpc_tpu_torch.train import finetune_step, optim

    model = lc.build_lc(cfg, ecfg.num_classes, torch.device("cuda"),
                        dropout=ecfg.dropout, seed=seed)
    opt = optim.finetune_optimizer(model, ecfg.lr, ecfg.wd, ecfg.train_what,
                                   ecfg.backbone_lr_scale)
    return model, finetune_step.make_finetune_step(cfg, ecfg, model, opt)


def _small_lc_check() -> None:
    """One f32 LC finetune step at a small size through the kernels (K1-K4)
    and through the plain paths (ATen stem pool, scan GRU), same weights,
    batch and labels, dropout off: the losses and the updated running
    statistics must agree."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, EvalConfig
    from dpc_tpu_torch.models import lc

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(4, 4, 5, 64, 64, 3, device=dev, generator=g)
        y = torch.randint(0, 11, (4,), device=dev, generator=g)
        ecfg = EvalConfig(num_classes=11, dropout=0.0, batch_size=4)
        loss, stats = {}, {}
        for gru_impl, stem in (("pallas", "pallas"), ("scan", "xla")):
            cfg = DPCConfig(img_dim=64, num_seq=4, seq_len=5,
                            gru_impl=gru_impl, gru_dropout=0.0)
            model, step = _lc_parts(cfg, ecfg)
            model.backbone.stem_pool_impl = stem
            loss[stem] = float(step(x, y)["loss"])
            stats[stem] = torch.cat([v.flatten()
                                     for v in lc.running_stats(model).values()])
        err = abs(loss["pallas"] - loss["xla"]) / abs(loss["xla"])
        serr = rel_err(stats["pallas"], stats["xla"])
        log(f"[lc] small f32 check: kernel path loss {loss['pallas']}, plain "
            f"path {loss['xla']}, rel diff {err:.2e}; running stats rel diff "
            f"{serr:.2e}")
        expect(err <= 1e-4 and serr <= 1e-4,
               f"LC kernel path and plain path disagree: {loss}, {serr}")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _lc_flagship():
    """The LC flagship's configs, model, step and device batch."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, EvalConfig

    dev = torch.device("cuda")
    cfg = DPCConfig(compute_dtype="bfloat16", gru_impl="pallas",
                    gru_dropout=0.1)
    ecfg = EvalConfig(num_classes=101, dropout=0.5, train_what="ft",
                      backbone_lr_scale=0.1, batch_size=32)
    model, step = _lc_parts(cfg, ecfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(ecfg.batch_size, cfg.num_seq, cfg.seq_len, cfg.img_dim,
                    cfg.img_dim, 3, device=dev, generator=gen)
    y = torch.randint(0, ecfg.num_classes, (ecfg.batch_size,), device=dev,
                      generator=gen)
    return cfg, ecfg, model, step, x, y, gen


def phase_lc(profile: str | None) -> dict:
    import torch
    from dpc_tpu_torch.ops import _build
    from dpc_tpu_torch.train import finetune_step, optim

    _small_lc_check()
    dev = torch.device("cuda")
    cfg, ecfg, model, step, x, y, gen = _lc_flagship()
    batch, classes = ecfg.batch_size, ecfg.num_classes
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(x, y, gen)
    torch.cuda.synchronize()

    n_steps = 10
    _build.reset_launches()
    t0 = time.perf_counter()
    metrics = [step(x, y, gen) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_launches("lc", n_steps, LC_KERNELS)
    losses = [float(m["loss"]) for m in metrics]
    log(f"[lc] R18-128 8x5 B={batch} bf16 {classes} classes gru=pallas "
        f"stem=auto: {n_steps * batch / dt:.2f} clips/s "
        f"({1e3 * dt / n_steps:.1f} ms/step, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    log(f"[lc] losses {losses}")
    log(f"[lc] top1 {[float(m['top1']) for m in metrics]}")
    expect(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    _profile(lambda: step(x, y, gen), profile,
             "LC finetune R18-128 8x5 B=32 bf16")
    opt = optim.finetune_optimizer(model, ecfg.lr, ecfg.wd, ecfg.train_what,
                                   ecfg.backbone_lr_scale)
    scan_step = finetune_step.make_finetune_step(
        dataclasses.replace(cfg, gru_impl="scan"), ecfg, model, opt)
    rates = _in_turns(lambda: scan_step(x, y, gen), lambda: step(x, y, gen),
                      batch)
    log(f"[lc] GRU path in turns: pallas (kernels) {rates['kernel']} clips/s,"
        f" scan (plain recurrence) {rates['plain']} clips/s")

    val = finetune_step.make_finetune_eval_step(cfg, ecfg, model)(x, y)
    val = {k: float(v) for k, v in val.items()}
    log(f"[lc] eval step: {val}")
    expect(all(math.isfinite(v) for v in val.values()), f"eval {val}")

    wb, n_fwd = 32, 10
    forward = finetune_step.make_test_forward(cfg, ecfg, model)
    windows = torch.randn(wb, cfg.num_seq, cfg.seq_len, cfg.img_dim,
                          cfg.img_dim, 3, device=dev, generator=gen)
    for _ in range(2):
        forward(windows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = [forward(windows) for _ in range(n_fwd)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[lc] dense-test forward WB={wb}: {n_fwd * wb / dt:.2f} windows/s "
        f"({1e3 * dt / n_fwd:.1f} ms/forward)")
    expect(logits[-1].shape == (wb, classes)
           and bool(torch.isfinite(logits[-1]).all()), "dense-test logits")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# 5. the CLIs
# ---------------------------------------------------------------------------

def _run_cli(main, argv, what: str, kernels, log_dir=None) -> str:
    """Run a CLI's ``main`` in this process with the launch counts set to 0
    just before it and read just after; its run directory goes under
    ``log_dir`` (a temporary directory when None)."""
    from dpc_tpu_torch.ops import _build

    _build.reset_launches()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        with contextlib.redirect_stdout(buf):
            main(argv + ["--log_dir", str(log_dir or tmp)])
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[{what}] {line}")
    log(f"[{what}] launches: {dict(_build.LAUNCHES)}")
    expect(all(_build.LAUNCHES[k] > 0 for k in kernels),
           f"a kernel did not run in the {what} CLI")
    return out


def phase_cli() -> None:
    from dpc_tpu_torch.train import evaluate, pretrain

    out = _run_cli(pretrain.main,
                   ["--dataset", "synthetic", "--nce_impl", "fused",
                    "--batch_size", "8", "--epochs", "1",
                    "--steps_per_epoch", "2", "--num_workers", "4",
                    "--print_freq", "1"], "cli", PRETRAIN_KERNELS)
    line = [ln for ln in out.splitlines() if ln.startswith("epoch 0: train")]
    expect(bool(line) and "[epoch 0] 2 train steps" in out,
           "CLI did not run 2 steps")
    loss = float(line[0].split("loss")[1].split()[0])
    expect(math.isfinite(loss), f"CLI loss {loss}")

    out = _run_cli(evaluate.main,
                   ["--dataset", "synthetic", "--batch_size", "8",
                    "--epochs", "1", "--steps_per_epoch", "2",
                    "--num_workers", "4", "--print_freq", "1"],
                   "finetune cli", LC_KERNELS)
    line = [ln for ln in out.splitlines() if ln.startswith("[epoch 0] 2 ")]
    expect(bool(line) and "val loss" in line[0],
           "finetune CLI did not run 2 steps and val")
    losses = [float(part.split()[0].rstrip(";"))
              for part in line[0].split("loss")[1:]]
    expect(len(losses) == 2 and all(math.isfinite(v) for v in losses),
           f"finetune CLI {losses}")

    out = _run_cli(evaluate.main,
                   ["--dataset", "synthetic", "--test", "random",
                    "--synthetic_videos", "4", "--num_workers", "4"],
                   "test cli", ("convgru_fwd", "maxpool_relu_fwd"))
    line = [ln for ln in out.splitlines() if ln.startswith("[test] loss")]
    expect(bool(line) and "top1" in line[0], "dense test printed no top1")


# ---------------------------------------------------------------------------
# 6. both CLIs on a JPEG frame tree
# ---------------------------------------------------------------------------

# the flagship of the pretrain CLI and the frame tree it reads
FRAMES_PRETRAIN = ["--net", "resnet18", "--img_dim", "128", "--num_seq", "8",
                   "--seq_len", "5", "--pred_step", "3", "--batch_size", "64",
                   "--nce_impl", "fused"]
FRAMES_LC = ["--net", "resnet18", "--img_dim", "128", "--num_seq", "8",
             "--seq_len", "5", "--batch_size", "64"]
FRAMES_TREE = dict(num_videos=16, num_frames=150, height=240, width=320,
                   num_classes=101, train_rows=640, test_rows=224)
# the host-recipe runs take 2 train steps an epoch; the --device_augment
# pretrain run takes all 10 (its second epoch is the measured one)
HOST_STEPS = ["--steps_per_epoch", "2"]
RESUME_TOL = 1e-3  # relative gap of a resumed step's loss to the original
AUG_TOL = 1e-5     # |card − CPU| of the device recipes after Normalize
# the stem's normalize fold on the card, uint8 windows at the flagship stem
# shape, max |error| over max |output| against normalise-then-conv in f32:
# in f32, and under bf16 autocast (bf16's 8-bit mantissa on the scaled
# weights and on the output)
FOLD_TOL = {"f32": 1e-5, "bf16": 2e-2}
# the scaled ROI decode against the full decode + HostScaleCrop's float
# resize, in levels (max, mean): nvJPEG resamples the full frame in 16.16
# fixed point; libjpeg resamples its DCT-scaled frame
ROI_SCALED_TOL = {"nvjpeg": (2, 0.6), "libjpeg": (8, 1.0)}


def _train_losses(out: str) -> dict:
    """{(epoch, step): loss} from the loop's progress lines."""
    found = re.findall(r"^\[train\] epoch (\d+) \[(\d+)/\d+\] loss (\S+)",
                       out, re.M)
    return {(int(e), int(i)): float(v) for e, i, v in found}


def _loader_rate(ds, batch: int, workers: int, mode: str, n_batches: int,
                 warm: int) -> float:
    """clips/s of a ClipLoader alone (no device work) over its batches
    after the first ``warm`` (a process pool's first batch waits for the
    workers to start; threads start at once)."""
    from dpc_tpu_torch.data.loader import ClipLoader

    loader = ClipLoader(ds, batch, num_workers=workers, worker_mode=mode,
                        seed=0)
    stamps = [time.perf_counter()]
    try:
        epoch = 0
        while len(stamps) <= n_batches:
            loader.set_epoch(epoch)
            for _ in loader:
                stamps.append(time.perf_counter())
                if len(stamps) > n_batches:
                    break
            epoch += 1
    finally:
        loader.close(wait=True)  # the next measurement wants the cores
    return (n_batches - warm) * batch / (stamps[-1] - stamps[warm])


def check_device_augment(paths, img_dim: int, device: str = "cuda") -> None:
    """The device half of --device_augment on the card against the same
    functions on the CPU with the same draws (the gathers bit-equal, the
    recipes within AUG_TOL after Normalize); the dense-test recipe on the
    card against the host's test transform on the same decoded frames
    (1e-6, Normalize's fused form); and the ROI decode against the full
    decode plus HostScaleCrop's numpy path with the same plan: bit-equal
    at scale 1, within ROI_SCALED_TOL levels at short side 128 (the codec
    resamples in 16.16 fixed point, the numpy path in float)."""
    import torch
    from dpc_tpu_torch import native
    from dpc_tpu_torch.data import augment
    from dpc_tpu_torch.data import device_augment as da

    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    b, n, sl = 4, 8, 5
    f = n * sl

    def same(name, cpu, card, tol):
        card = card.cpu()
        exact = torch.equal(cpu, card)
        err = float((cpu.double() - card.double()).abs().max())
        log(f"[augment] {name}: card against CPU, max |diff| {err:.3e}"
            + (" (bit-equal)" if exact else ""))
        expect(exact if tol == 0 else err <= tol,
               f"device augment {name}: card and CPU differ by {err}")

    for h, w in ((224, 224), (240, 320)):
        clips = torch.randint(0, 256, (b, n, sl, h, w, 3), generator=gen,
                              dtype=torch.uint8)
        flat = clips.reshape(b, f, h, w, 3)
        on = clips.to(dev)
        flip = torch.rand(b, generator=gen) < 0.5
        same(f"resize_fixed {h}x{w}", da.resize_fixed(flat, img_dim, flip),
             da.resize_fixed(on.reshape(b, f, h, w, 3), img_dim,
                             flip.to(dev)), 0)
        same(f"center_crop_resize {h}x{w}",
             da.center_crop_resize(flat, 224, img_dim),
             da.center_crop_resize(on.reshape(b, f, h, w, 3), 224, img_dim),
             0)
        for five in (False, True):
            same(f"test_preprocess_batch {h}x{w} five_crop={five}",
                 da.test_preprocess_batch(clips, img_dim, 224, five, False),
                 da.test_preprocess_batch(on, img_dim, 224, five, False), 0)
        for recipe in ("crop_resize", "sized_crop"):
            d = da.draw_pretrain(gen, b, f, h, w, recipe)
            x = da.resize_fixed(flat, img_dim) / 255.0
            same(f"random_gray {h}x{w}",
                 da.random_gray(x, d.gray, d.gray_chan),
                 da.random_gray(x.to(dev), d.gray.to(dev),
                                d.gray_chan.to(dev)), 0)
            for norm in (False, True):
                same(f"augment_batch {recipe} {h}x{w} normalize={norm}",
                     da.augment_batch(clips, d, img_dim, recipe, norm),
                     da.augment_batch(on, d.to(dev), img_dim, recipe, norm),
                     AUG_TOL)
        for mode in ("train", "val"):
            d = da.draw_finetune(gen, b, h, w, mode)
            same(f"finetune_augment_batch {mode} {h}x{w}",
                 da.finetune_augment_batch(clips, d, img_dim, mode),
                 da.finetune_augment_batch(on, d.to(dev), img_dim, mode),
                 AUG_TOL)

    # the dense-test recipe: ROI-decoded centre windows on the card, the
    # host transform on full decodes (and five crops of the full frames)
    buffers = [Path(p).read_bytes() for p in paths[:f]]
    src_hw = native.jpeg_dims(buffers[0])
    frames, fails = native.decode_jpeg_batch(buffers, *src_hw)
    one = np.stack([native.decode_jpeg(x) for x in buffers])
    d = np.abs(frames.astype(np.int64) - one)
    log(f"[augment] batch full decode against one frame at a time "
        f"({native.backend()}): max |diff| {d.max()}, mean {d.mean():.4f} "
        f"levels")
    expect(fails == 0 and d.max() == 0,
           f"the batch decode is off the per-frame one: {d.max()}")
    plan = augment.HostScaleCrop(240, (224, 224), center=True).plan(
        src_hw, None)
    windows, fails = native.decode_jpeg_batch_scale_crop(buffers, *plan)
    expect(fails == 0, f"{fails} centre windows did not decode")
    for five, src in ((False, windows), (True, frames)):
        host = augment.finetune_transform(img_dim, "test", five_crop=five)(
            frames)
        card = da.test_preprocess_batch(
            torch.from_numpy(src).to(dev).reshape(1, n, sl, *src.shape[1:]),
            img_dim, 224, five_crop=five).cpu().numpy()
        err = float(np.abs(card.reshape(host.shape) - host).max())
        log(f"[augment] dense-test recipe on the card against the host "
            f"transform, five_crop={five}: max |diff| {err:.2e}")
        expect(err <= 1e-6, f"dense-test recipe off by {err}")

    # the ROI decode against the full decode and the numpy geometry
    for short, win in ((240, (224, 224)), (128, (128, 128))):
        host = augment.HostScaleCrop(short, win)
        plan = host.plan(src_hw, np.random.default_rng(short))
        got, fails = native.decode_jpeg_batch_scale_crop(buffers, *plan)
        want = host(frames, np.random.default_rng(short))
        d = np.abs(got.astype(np.int64) - want)
        log(f"[augment] ROI decode ({native.backend()}) short {short} "
            f"plan {plan[1]} against full decode + HostScaleCrop: max |diff| "
            f"{d.max()}, mean {d.mean():.4f} levels")
        expect(fails == 0 and got.shape == want.shape, "ROI decode failed")
        if short == 240:
            expect(d.max() == 0, "ROI decode at scale 1 is not bit-equal")
        else:
            tmax, tmean = ROI_SCALED_TOL[native.backend()]
            expect(d.max() <= tmax and d.mean() <= tmean,
                   f"ROI decode at short {short}: {d.max()}, {d.mean()}")
    check_input_norm_fold(device)


def check_input_norm_fold(device: str = "cuda", shape=(512, 5, 128, 128),
                          seed: int = 0) -> dict:
    """The stem's normalize fold (``layers.conv3d_input_norm`` with
    ``INPUT_NORM_U8``, as the dense test runs it) on the card: uint8
    windows at the flagship stem shape (B64 x N8 windows of 5 frames of
    128²), in f32 and under bf16 autocast, against normalise-then-conv in
    f32 (TF32 off) on the same input; normalise-then-conv under bf16
    autocast is printed beside it as the scale of bf16's own error."""
    import torch
    from dpc_tpu_torch.data import device_augment as da
    from dpc_tpu_torch.models import layers as L

    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    conv = L.conv3d(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3)).to(dev)
    x = torch.randint(0, 256, (*shape, 3), generator=gen,
                      dtype=torch.uint8).to(dev).permute(0, 4, 1, 2, 3)
    mean, std, _ = da.INPUT_NORM_U8
    mean = torch.as_tensor(mean, device=dev).view(1, 3, 1, 1, 1)
    std = torch.as_tensor(std, device=dev).view(1, 3, 1, 1, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        with torch.no_grad():
            want = conv((x.float() / 255.0 - mean) / std)
            scale = float(want.abs().max())

            def rel(got):
                return float((got.float() - want).abs().max()) / scale

            errs["f32"] = rel(L.conv3d_input_norm(conv, x, da.INPUT_NORM_U8))
            with torch.autocast(dev.type, dtype=torch.bfloat16):
                errs["bf16"] = rel(L.conv3d_input_norm(conv, x,
                                                       da.INPUT_NORM_U8))
                plain = rel(conv((x.float() / 255.0 - mean) / std))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log(f"[augment] stem normalize fold, uint8 {list(x.shape)} on the card, "
        f"max |error| / max |output| against normalise-then-conv in f32: "
        f"fold f32 {errs['f32']:.3e}, fold bf16 {errs['bf16']:.3e} "
        f"(normalise-then-conv in bf16: {plain:.3e})")
    for k, tol in FOLD_TOL.items():
        expect(errs[k] <= tol, f"the stem fold in {k} is off by {errs[k]:.3e}")
    return errs


def _copy_overlap(device, n: int = 6) -> dict:
    """The --device_augment pretrain flagship step (uint8 224² windows,
    the recipe on the card) alone, the pinned host-to-device copy of its
    B64 batch alone, and both as the CLI runs them (the copy of batch i+1
    on a side stream while step i computes); and the recipe's own time
    (CUDA events).  The copy overlaps when the pair costs about a step."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
    from dpc_tpu_torch.data import device_augment as da
    from dpc_tpu_torch.models import dpc
    from dpc_tpu_torch.train import loop, optim, pretrain_step

    cfg = DPCConfig(compute_dtype="bfloat16", gru_impl="pallas")
    tcfg = TrainConfig(batch_size=64, nce_impl="fused", device_augment=True,
                       device_augment_recipe="crop_resize")
    model = dpc.build_dpc(cfg, device, seed=0)
    step = pretrain_step.make_pretrain_step(
        cfg, tcfg, model, optim.pretrain_optimizer(model, 1e-3, 1e-5))
    gen = torch.Generator(device=device).manual_seed(1)
    aug = torch.Generator().manual_seed(2)
    host = torch.randint(0, 256, (64, cfg.num_seq, cfg.seq_len, 224, 224, 3),
                         dtype=torch.uint8).pin_memory()
    feed = loop.DeviceFeed(device)
    on = feed(host)

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    out = {"step_ms": timed(lambda: step(on, gen, aug)),
           "copy_ms": timed(lambda: feed(host)),
           "step_and_copy_ms": timed(lambda: step(feed(host), gen, aug))}
    out["copy_overlaps"] = (out["step_and_copy_ms"]
                            < out["step_ms"] + 0.5 * out["copy_ms"])
    draws = da.draw_pretrain(aug, 64, cfg.num_seq * cfg.seq_len, 224, 224,
                             "crop_resize").to(device)
    out["augment_ms"] = cuda_ms(lambda: da.augment_batch(
        on, draws, cfg.img_dim, "crop_resize"), iters=10)
    log(f"[frames] --device_augment step on device-resident uint8: "
        f"{out['step_ms']:.1f} ms; H2D copy of the B64 batch "
        f"({host.numel() / 2**20:.0f} MiB, pinned): {out['copy_ms']:.1f} "
        f"ms; both as the CLI queues them: {out['step_and_copy_ms']:.1f} "
        f"ms/step (copy overlaps: {out['copy_overlaps']}); the recipe "
        f"alone: {out['augment_ms']:.2f} ms/step (CUDA events)")
    return out


def _codec_ms(profile: Path) -> tuple[float, int, dict]:
    """nvJPEG's device time in a CLI's --profile window: kernels that do
    not belong to the step, by name (the step's are torch's, cuDNN's,
    cuBLAS's and the port's)."""
    rec = json.loads(Path(str(profile) + ".json").read_text())
    kernels = sorted(rec["kernels_ms"].items(), key=lambda kv: -kv[1])
    codec = {k: v for k, v in kernels
             if re.search(r"jpeg|idct|huff|ycbcr|yuv|color_?conv", k, re.I)}
    for k, v in kernels[:15]:
        log(f"[frames] profile kernel {v:9.3f} ms  {k[:110]}")
    return sum(codec.values()), rec["steps"], codec


def _frames_device_augment(tmp: Path, data, pre_args, lc_args, paths,
                           workers: int, device: str) -> dict:
    """--device_augment on the same tree: the pretrain CLI at the flagship
    for 2 epochs of 10 steps (clips/s and busy share over its second
    epoch, nvJPEG's device time from its --profile), an epoch resume that
    reruns step (1, 0), the same 2 epochs with process workers, the
    finetune CLI from the first run, the dense test of
    the finetune run plain, with --five_crop, and with the host recipe;
    the planned-decode fallbacks (0 expected); the loader alone with the
    host half; one thread's ROI decode; the copy and the recipe on the
    card."""
    import torch
    from dpc_tpu_torch import native
    from dpc_tpu_torch.train import evaluate, loop, pretrain

    aug = ["--device_augment"]
    rates = {}
    fallbacks = []  # each run's count, from its "[feed]" line

    def run(main, argv, what, kernels, log_dir=None) -> str:
        out = _run_cli(main, argv, what, kernels, log_dir=log_dir)
        found = re.findall(r"^\[feed\] planned-decode fallbacks: "
                           r"\{'unplanned': (\d+), 'undecoded': (\d+)\}",
                           out, re.M)
        expect(bool(found), f"{what} printed no planned-decode fallbacks")
        fallbacks.extend(int(a) + int(b) for a, b in found)
        return out

    log_dir = tmp / "da_pretrain"
    log_dir.mkdir()
    snap = tmp / "da_epoch"

    def run_dir(d: Path) -> Path:
        (run,) = [p for p in d.iterdir() if p.is_dir()]
        return run

    def snap_epoch():  # before step (1, 0): the epoch-1 file
        (snap / "model").mkdir(parents=True)
        shutil.copy(run_dir(log_dir) / "model" / "epoch1.pth.tar",
                    snap / "model")

    hooks = {(1, 0): snap_epoch}
    real_seed = loop.step_seed

    def hooked_seed(seed, epoch, idx, *stream):
        hook = hooks.pop((epoch, idx), None)
        if hook is not None:
            hook()
        return real_seed(seed, epoch, idx, *stream)

    profile = tmp / "da_profile.txt"
    loop.step_seed = hooked_seed
    try:
        out = run(pretrain.main, [
            *data, *pre_args, *aug, "--epochs", "2", "--profile",
            str(profile)], "da pretrain", PRETRAIN_KERNELS, log_dir=log_dir)
    finally:
        loop.step_seed = real_seed
    expect(not hooks, "the epoch-checkpoint hook did not run")
    vals = [ln for ln in out.splitlines()
            if re.match(r"epoch \d: train loss", ln) and "| val loss" in ln]
    expect(len(vals) == 2, "the --device_augment pretrain CLI printed no "
                           "val line in each of its two epochs")
    losses = _train_losses(out)
    expect(len(losses) >= 16 and all(math.isfinite(v)
                                     for v in losses.values()),
           f"--device_augment pretrain losses {losses}")
    busy = re.search(r"\[profile\] (\d+) train steps: wall (\S+) ms, "
                     r"(\S+) clips/s, device busy (\S+) ms \((\S+)%\)", out)
    expect(busy is not None and int(busy.group(1)) >= 8,
           "the --device_augment CLI profiled fewer than 8 steps")
    rates["da_cli_clips_per_s"] = float(busy.group(3))
    rates["da_cli_busy_pct"] = float(busy.group(5))
    if device == "cuda":
        codec_ms, steps, _ = _codec_ms(profile)
        rates["nvjpeg_device_ms_per_step"] = codec_ms / steps
        log(f"[frames] nvJPEG kernels: {codec_ms:.1f} ms of device time "
            f"over {steps} steps = {codec_ms / steps:.2f} ms/step, of "
            f"{float(busy.group(4)) / steps:.1f} ms/step busy")

    out = run(pretrain.main, [
        *data, *pre_args, *aug, "--resume", str(snap), "--epochs", "2",
        "--steps_per_epoch", "1"], "da resume epoch", ("nce_fwd",))
    got = _train_losses(out)
    expect("resumed epoch 1" in out and list(got) == [(1, 0)],
           f"the --device_augment epoch resume ran steps {list(got)}")
    gap = abs(got[(1, 0)] - losses[(1, 0)]) / abs(losses[(1, 0)])
    rates["da_resume_gap"] = gap
    log(f"[frames] --device_augment epoch resume: step (1, 0) loss "
        f"{got[(1, 0)]:.6f} against {losses[(1, 0)]:.6f} uninterrupted, "
        f"relative gap {gap:.2e}")
    expect(gap <= RESUME_TOL, f"--device_augment resume gap {gap:.2e}")

    # the same run with process workers (they send their fallbacks back)
    out = run(pretrain.main, [
        *data, *pre_args, *aug, "--epochs", "2", "--worker_mode", "process",
        "--profile", str(tmp / "da_profile_process.txt")],
        "da pretrain process workers", PRETRAIN_KERNELS,
        log_dir=tmp / "da_process")
    busy = re.search(r"\[profile\] (\d+) train steps: wall \S+ ms, "
                     r"(\S+) clips/s, device busy \S+ ms \((\S+)%\)", out)
    expect(busy is not None and int(busy.group(1)) >= 8,
           "the process-worker CLI profiled fewer than 8 steps")
    rates["da_cli_process_clips_per_s"] = float(busy.group(2))
    rates["da_cli_process_busy_pct"] = float(busy.group(3))

    ft_dir = tmp / "da_finetune"
    out = run(evaluate.main, [
        *data, *lc_args, *aug, "--epochs", "1", "--steps_per_epoch", "4",
        "--pretrain", str(run_dir(log_dir))], "da finetune", LC_KERNELS,
        log_dir=ft_dir)
    expect("[transfer_load] loaded" in out and any(
        ln.startswith("epoch 0: train top1") and "| val top1" in ln
        for ln in out.splitlines()), "the --device_augment finetune CLI "
                                    "did not train and validate")
    test_loss = {}
    for name, extra in (("da", aug), ("da five_crop", [*aug, "--five_crop"]),
                        ("host", [])):
        out = (run if extra else _run_cli)(evaluate.main, [
            *data, *lc_args, *extra, "--test", str(run_dir(ft_dir)),
            "--split", "2"], f"test {name}",
            ("convgru_fwd", "maxpool_relu_fwd"))
        line = [ln for ln in out.splitlines() if ln.startswith("[test] loss")]
        expect(bool(line) and "16 videos" in out, f"test {name}: no result")
        test_loss[name] = float(line[0].split()[2].rstrip(";"))
    gap = abs(test_loss["da"] - test_loss["host"]) / abs(test_loss["host"])
    log(f"[frames] dense test of the --device_augment finetune run: loss "
        f"{test_loss} (card recipe, stem fold, against the host recipe: "
        f"relative gap {gap:.2e})")
    expect(all(math.isfinite(v) for v in test_loss.values()) and gap <= 1e-3,
           f"the dense test's card and host recipes disagree: {test_loss}")
    rates["planned_fallbacks"] = sum(fallbacks)
    log(f"[frames] planned-decode fallbacks over the {len(fallbacks)} "
        f"--device_augment runs: {rates['planned_fallbacks']}")
    expect(rates["planned_fallbacks"] == 0,
           f"the planned decode fell back: {fallbacks}")

    # the file system: the frame tree is one file a frame
    tree = sorted(Path(data[data.index("--data_root") + 1]).glob(
        "ucf101/frame/*/*/*.jpg"))
    for w in (1, workers):
        with ThreadPoolExecutor(w) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda p: len(p.read_bytes()), tree))
            rates[f"file_reads_per_s_{w}_threads"] = (
                len(tree) / (time.perf_counter() - t0))
        log(f"[frames] reading the tree's {len(tree)} frame files with {w} "
            f"thread(s): {rates[f'file_reads_per_s_{w}_threads']:.0f} "
            f"files/s")

    # the host half alone
    batch = int(pre_args[pre_args.index("--batch_size") + 1])
    ds = pretrain.get_dataset(pretrain.config_from_args(
        pretrain.build_parser().parse_args([*data, *pre_args, *aug])),
        "train")
    for mode, n, warm in (("thread", 6, 1), ("process", 6, 2)):
        key = f"da_loader_{mode}_clips_per_s"
        rates[key] = _loader_rate(ds, batch, workers, mode, n, warm)
        log(f"[frames] loader alone with the host half, {mode} mode, "
            f"{workers} workers, B={batch}, batches {warm + 1}-{n}: "
            f"{rates[key]:.2f} clips/s")
    buffers = [Path(p).read_bytes() for p in paths]
    plan = ds.transform.plan(native.jpeg_dims(buffers[0]),
                             np.random.default_rng(0))
    t0 = time.perf_counter()
    _, fails = native.decode_jpeg_batch_scale_crop(buffers, *plan, threads=1)
    rates["roi_decode_ms_per_frame"] = (
        1e3 * (time.perf_counter() - t0) / len(buffers))
    expect(fails == 0, "ROI decode failed")
    log(f"[frames] one thread: ROI decode {plan} of one video's "
        f"{len(buffers)} frames in one call "
        f"{rates['roi_decode_ms_per_frame']:.3f} ms/frame "
        f"({native.backend()}); --device_augment train CLI "
        f"{rates['da_cli_clips_per_s']:.2f} clips/s in its second epoch, "
        f"device busy {rates['da_cli_busy_pct']:.1f}%")
    if device == "cuda":
        rates.update(_copy_overlap(torch.device(device)))
    return rates


def phase_frames(pre_args=FRAMES_PRETRAIN, lc_args=FRAMES_LC,
                 tree_kw=FRAMES_TREE, device: str = "cuda") -> dict:
    """Both CLIs on a UCF-shaped JPEG tree written with the port's encoder.
    The pretrain CLI runs two epochs with a val epoch each and step
    checkpoints; a hook on the dropout seed (called as each train step is
    queued) copies the run's checkpoints as they stand before step (0, 1)
    and before step (1, 0).  From those copies a mid-epoch resume (the step
    file alone) and an epoch resume each rerun one step, whose loss must
    match the uninterrupted run's.  Then the finetune CLI from the pretrain
    run, the dense test of the finetune run, and the feed's rates: the
    pretrain CLI's clips/s and busy share in its second train epoch (its
    ``--profile``), the loader alone, one thread's decode and augment."""
    from dpc_tpu_torch import native
    from dpc_tpu_torch.data import augment
    from dpc_tpu_torch.data.frame_tree import render_frames, write_frame_tree
    from dpc_tpu_torch.train import evaluate, loop, pretrain

    workers = os.cpu_count() or 1
    for cmd in (["ls", "-l", "/usr/include/jpeglib.h"],
                ["sh", "-c", "ldconfig -p | grep -i jpeg"]):
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        log(f"[frames] $ {' '.join(cmd)}: "
            f"{(res.stdout + res.stderr).strip() or '(nothing)'}")
    t0 = time.perf_counter()
    log(f"[frames] JPEG codec: {native.backend()} "
        f"(built in {time.perf_counter() - t0:.1f} s); cpu_count {workers}")
    rates = {"cpu_count": workers, "backend": native.backend()}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        root = write_frame_tree(str(tmp / "data"), workers=workers,
                                **tree_kw)
        base = Path(root) / "ucf101"
        rows = (base / "test_split01.csv").read_text().splitlines()
        (base / "test_split02.csv").write_text("\n".join(rows[:16]) + "\n")
        n_frames = tree_kw["num_videos"] * tree_kw["num_frames"]
        log(f"[frames] wrote {n_frames} JPEG frames of "
            f"{tree_kw['width']}x{tree_kw['height']} in "
            f"{time.perf_counter() - t0:.1f} s")
        # the codec against the frames it was given (video 0)
        first = sorted((base / "frame").glob("*/*"))[0]
        src = render_frames(0, np.arange(3), tree_kw["height"],
                            tree_kw["width"])
        got = np.stack([native.decode_file(str(first / f"image_{i:05d}.jpg"))
                        for i in (1, 2, 3)])
        err = float(np.abs(got.astype(np.float64) - src).mean())
        log(f"[frames] decoded against the source: mean |error| {err:.3f} "
            "levels")
        expect(got.shape == src.shape and err < 3.0,
               f"the codec's round trip is off by {err:.3f} levels")

        data = ["--dataset", "ucf101", "--data_root", root,
                "--num_workers", str(workers), "--print_freq", "1",
                "--device", device]
        log_dir = tmp / "pretrain"
        log_dir.mkdir()
        snaps = {"mid": tmp / "mid", "epoch": tmp / "epoch"}

        def run_dir() -> Path:
            (run,) = [p for p in log_dir.iterdir() if p.is_dir()]
            return run

        def snap_mid():  # before step (0, 1): the step file of (0, 0)
            shutil.copytree(run_dir() / "model_steps",
                            snaps["mid"] / "model_steps")

        def snap_epoch():  # before step (1, 0): the epoch-1 file
            (snaps["epoch"] / "model").mkdir(parents=True)
            shutil.copy(run_dir() / "model" / "epoch1.pth.tar",
                        snaps["epoch"] / "model")

        hooks = {(0, 1): snap_mid, (1, 0): snap_epoch}
        real_seed = loop.step_seed

        def hooked_seed(seed, epoch, idx, *stream):
            hook = hooks.pop((epoch, idx), None)
            if hook is not None:
                hook()
            return real_seed(seed, epoch, idx, *stream)

        profile = tmp / "profile.txt"
        loop.step_seed = hooked_seed
        try:
            out = _run_cli(pretrain.main, [
                *data, *pre_args, *HOST_STEPS, "--epochs", "2",
                "--save_every_steps", "1", "--profile", str(profile)],
                "frames pretrain", PRETRAIN_KERNELS, log_dir=log_dir)
        finally:
            loop.step_seed = real_seed
        expect(not hooks, f"the checkpoint hooks did not all run: {hooks}")
        vals = [ln for ln in out.splitlines()
                if re.match(r"epoch \d: train", ln) and "| val loss" in ln]
        expect(len(vals) == 2, "the pretrain CLI printed no val line in "
                               "each of its two epochs")
        losses = _train_losses(out)
        expect(len(losses) == 4
               and all(math.isfinite(v) for v in losses.values()),
               f"pretrain CLI losses {losses}")
        names = sorted(p.name for p in (run_dir() / "model").iterdir())
        expect(names[0] == "epoch2.pth.tar" and len(names) == 2
               and names[1].startswith("model_best_epoch"),
               f"model/ holds {names}, not the latest and the best")
        busy = re.search(r"\[profile\] (\d+) train steps: wall (\S+) ms, "
                         r"(\S+) clips/s, device busy \S+ ms \((\S+)%\)",
                         out)
        expect(busy is not None, "the pretrain CLI printed no profile line")
        rates["cli_clips_per_s"] = float(busy.group(3))
        rates["cli_busy_pct"] = float(busy.group(4))

        gaps = {}
        for name, argv, key, line in (
                ("mid-epoch", ["--epochs", "1", "--save_every_steps", "1",
                               *HOST_STEPS],
                 (0, 1), "resumed mid-epoch: epoch 0 batch 1"),
                ("epoch", ["--epochs", "2", "--steps_per_epoch", "1"],
                 (1, 0), "resumed epoch 1")):
            out = _run_cli(pretrain.main, [
                *data, *pre_args, "--resume", str(snaps[name.split("-")[0]]),
                *argv], f"frames resume {name}", ("nce_fwd",))
            expect(line in out, f"the {name} resume printed no '{line}'")
            got = _train_losses(out)
            expect(list(got) == [key], f"{name} resume ran steps {list(got)}")
            gaps[name] = abs(got[key] - losses[key]) / abs(losses[key])
            log(f"[frames] {name} resume: step {key} loss {got[key]:.6f} "
                f"against {losses[key]:.6f} uninterrupted, relative gap "
                f"{gaps[name]:.2e}")
            expect(gaps[name] <= RESUME_TOL,
                   f"{name} resume gap {gaps[name]:.2e} > {RESUME_TOL}")

        ft_dir = tmp / "finetune"
        out = _run_cli(evaluate.main, [
            *data, *lc_args, *HOST_STEPS, "--epochs", "1", "--pretrain",
            str(run_dir())], "frames finetune", LC_KERNELS, log_dir=ft_dir)
        expect("[transfer_load] loaded" in out and any(
            ln.startswith("epoch 0: train") and "| val top1" in ln
            for ln in out.splitlines()), "the finetune CLI did not train "
                                        "from the pretrain run and validate")
        (ft_run,) = [p for p in ft_dir.iterdir() if p.is_dir()]
        out = _run_cli(evaluate.main, [
            *data, *lc_args, "--test", str(ft_run), "--split", "2"],
            "frames test", ("convgru_fwd", "maxpool_relu_fwd"))
        top1 = [ln for ln in out.splitlines() if ln.startswith("[test] loss")]
        expect(bool(top1) and "top1" in top1[0] and "16 videos" in out,
               "the dense test of the finetune run printed no top1")

        # the feed alone
        train_ds = pretrain.get_dataset(
            pretrain.config_from_args(pretrain.build_parser().parse_args(
                [*data, *pre_args])), "train")
        batch = int(pre_args[pre_args.index("--batch_size") + 1])
        for mode, n, warm in (("thread", 2, 0), ("process", 3, 1)):
            rates[f"loader_{mode}_clips_per_s"] = _loader_rate(
                train_ds, batch, workers, mode, n, warm)
            log(f"[frames] loader alone, {mode} mode, {workers} workers, "
                f"B={batch}, batches {warm + 1}-{n}: "
                f"{rates[f'loader_{mode}_clips_per_s']:.2f} clips/s")
        paths = sorted(first.glob("*.jpg"))
        t0 = time.perf_counter()
        frames = np.stack([native.decode_file(str(p)) for p in paths])
        rates["decode_ms_per_frame"] = (
            1e3 * (time.perf_counter() - t0) / len(paths))
        img_dim = int(pre_args[pre_args.index("--img_dim") + 1])
        recipe = augment.pretrain_transform("ucf101", img_dim)
        rng = np.random.default_rng(0)
        clip_len = 40
        t0 = time.perf_counter()
        for i in range(0, len(frames) - clip_len + 1, clip_len):
            recipe(frames[i:i + clip_len], rng)
        n_clips = len(frames) // clip_len
        rates["augment_ms_per_clip"] = (
            1e3 * (time.perf_counter() - t0) / n_clips)
        log(f"[frames] one thread: decode {rates['decode_ms_per_frame']:.3f} "
            f"ms/frame ({native.backend()}), pretrain augment "
            f"{rates['augment_ms_per_clip']:.1f} ms/clip of {clip_len} "
            f"frames; train CLI {rates['cli_clips_per_s']:.2f} clips/s in "
            f"its second epoch, device busy {rates['cli_busy_pct']:.1f}%")
        if device == "cuda":
            check_device_augment(paths, img_dim)
        rates.update(_frames_device_augment(
            tmp, data, pre_args, lc_args, paths, workers, device))
    return rates


# ---------------------------------------------------------------------------

def kernels_line(k: dict, launches: dict) -> dict:
    """The per-kernel JSON record: K3-K4 and the pool kernels at the LC
    flagship shapes with the LC path's launches, K5-K6 at the pretrain
    shapes with the pretrain path's launches."""
    def row(name, src, replaces, t, err, n):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"]}

    g, n, p = k["gru_lc"], k["nce"], k["pool"]
    lc_n, pre_n = launches["lc"], launches["pretrain"]
    gru_src, nce_src = ("dpc_tpu_torch/csrc/convgru.cu",
                        "dpc_tpu_torch/csrc/nce.cu")
    pool_src, pool_tpu = ("dpc_tpu_torch/csrc/maxpool.cu",
                          "dpc_tpu/ops/maxpool_pallas.py")
    return {"kernels": [
        row("convgru_fwd", gru_src, "dpc_tpu/ops/convgru_pallas.py:88",
            g["fwd"], g["fwd_err"], lc_n["convgru_fwd"]),
        row("convgru_bwd", gru_src, "dpc_tpu/ops/convgru_pallas.py:207",
            g["bwd"], g["bwd_err"], lc_n["convgru_bwd"]),
        row("nce_fwd", nce_src, "dpc_tpu/ops/nce_pallas.py:97",
            n["fwd"], n["fwd_err"], pre_n["nce_fwd"]),
        row("nce_bwd", nce_src, "dpc_tpu/ops/nce_pallas.py:224",
            n["bwd"], n["bwd_err"], pre_n["nce_bwd"]),
        row("maxpool_relu_fwd", pool_src, f"{pool_tpu}:163", p["fwd"],
            p["fwd"]["err"], lc_n["maxpool_relu_fwd"]),
        row("maxpool_relu_bwd", pool_src, f"{pool_tpu}:208", p["bwd"],
            p["bwd"]["err"], lc_n["maxpool_relu_bwd"]),
        row("maxpool_bwd_eq", pool_src, f"{pool_tpu}:303", p["eq"],
            p["eq"]["err"], lc_n["maxpool_bwd_eq"]),
    ]}


def rates_only(n_steps: int = 20) -> dict:
    """clips/s of the pretrain and LC flagship steps (2 warm-up and
    n_steps timed steps each), nothing checked: for comparing the
    dpc_tpu_torch of two commits in turns, one process each."""
    import torch
    from dpc_tpu_torch.ops import _build

    _build.build()
    rates = {}
    _, tcfg, _, step, x, gen = _pretrain_flagship()
    _, ecfg, _, lc_step, lx, ly, lgen = _lc_flagship()
    for name, fn, batch in (
            ("pretrain", lambda: step(x, gen), tcfg.batch_size),
            ("lc", lambda: lc_step(lx, ly, lgen), ecfg.batch_size)):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        rates[name] = n_steps * batch / (time.perf_counter() - t0)
    return rates


def cli_rates(pairs, steps: int = 4) -> list:
    """clips/s and busy share of the pretrain CLI at the flagship on a
    FRAMES_TREE tree in its second epoch (its --profile), for each
    ``(recipe, root)``: the checkout's CLI and the one under ``root`` in
    turns (root, here, here, root), one process each; the recipe is
    'device_augment' (all 10 steps an epoch) or 'host' (``steps`` an
    epoch).  Nothing is checked: for comparing two commits' feeds."""
    from dpc_tpu_torch.data.frame_tree import write_frame_tree

    extra = {"device_augment": ["--device_augment"],
             "host": ["--steps_per_epoch", str(steps)]}
    found = []
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        data = ["--dataset", "ucf101", "--data_root", write_frame_tree(
            str(Path(tmp) / "data"), workers=os.cpu_count() or 1,
            **FRAMES_TREE), "--num_workers", str(os.cpu_count() or 1),
            "--print_freq", "1", "--device", "cuda"]
        for recipe, other in pairs:
            for i, root in enumerate((Path(other).resolve(), ROOT, ROOT,
                                      Path(other).resolve())):
                run = Path(tmp) / f"{recipe}{i}"
                proc = subprocess.run(
                    [sys.executable, "-m", "dpc_tpu_torch.train.pretrain",
                     *data, *FRAMES_PRETRAIN, *extra[recipe], "--epochs", "2",
                     "--log_dir", str(run), "--profile", f"{run}.txt"],
                    cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
                    capture_output=True, text=True, timeout=600)
                busy = re.search(r"\[profile\] (\d+) train steps: wall \S+ "
                                 r"ms, (\S+) clips/s, device busy \S+ ms "
                                 r"\((\S+)%\)", proc.stdout)
                found.append({"recipe": recipe, "root": str(root),
                              "rc": proc.returncode,
                              "steps": busy and int(busy.group(1)),
                              "clips_per_s": busy and float(busy.group(2)),
                              "busy_pct": busy and float(busy.group(3))})
                print(json.dumps(found[-1]), flush=True)
                if proc.returncode:
                    print(proc.stderr[-3000:], file=sys.stderr, flush=True)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="")
    ap.add_argument("--rates", metavar="ROOT", default="",
                    help="only time the pretrain and LC flagship steps of "
                         "the dpc_tpu_torch under ROOT and print one JSON "
                         "line (no checks, no ok line)")
    ap.add_argument("--cli_rates", metavar="RECIPE=ROOT", action="append",
                    default=[],
                    help="only time the pretrain CLI on a frame tree with "
                         "RECIPE (device_augment or host) for this checkout "
                         "and the one under ROOT in turns; repeatable")
    args = ap.parse_args(argv)
    if args.rates:
        sys.path.insert(0, str(Path(args.rates).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        import dpc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: dpc_tpu_torch not found beside this script ({e})",
              file=sys.stderr)
        return 3
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    if args.rates:
        print(json.dumps({"root": args.rates, **rates_only()}))
        return 0
    if args.cli_rates:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip())
        cli_rates([pair.split("=", 1) for pair in args.cli_rates])
        return 0
    t0 = time.perf_counter()
    try:
        phase_build()
        k = phase_kernels(args.profile or None)
        s = phase_step(args.profile or None)
        lc = phase_lc(args.profile or None)
        phase_cli()
        frames = phase_frames()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"[frames] rates on {smi.stdout.strip()}: {json.dumps(frames)}")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line(k, {"pretrain": s["launches"],
                                      "lc": lc["launches"]})))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}", file=sys.stderr)
        return 1
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
