"""Smoke run of dpc_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, and drives the DPC pretrain
step and the LC finetune, eval and dense-test path at their full width,
the CLIs, and the bench, profiling and debug tools.

    python3 chip_smoke.py [--profile PATH]

Phases, each printing its facts before the next starts:
  1. build    compile csrc/*.cu for sm_90a (one nvcc per source, in
              parallel); count the tensor-core instructions (HGMMA, HMMA)
              in the SASS of the nce and convgru libraries, and the TMA
              loads (UTMALDG) and 128-bit stores of K8's vector path
  2. kernels  K-GRU-F/B, K-NCE-F/B and the stem pool's K1 (and its
              ReLU-off instance, the fused stem's pool; K2 through either's
              codes)/K2/K8 against their plain versions on the card, at the pretrain and LC
              shapes, the 6144-row NCE shape, R50's D=1024, a D that is
              not a multiple of 32, ragged shapes, a rank's tile of
              {data:2} global negatives (1536x3072), data with exact ties and
              data with NaNs (K1 propagates them as dpc_tpu's kernel and
              ATen do, K8 routes nothing from a window that holds one), K8
              and its ReLU-gated variant also at a C of 20 (bf16: the
              scalar path; f32: 80-byte pixels) and on data off 16-byte
              alignment (the scalar path), with f32
              matmul and cuDNN TF32 off; values and grads; the stem
              activation's layout as the backbone makes it
  3. step     a small f32 step through the kernels, and through the kernels
              with the fused stem (the ReLU-off K1 and K2) and with the
              eqroute stem (K1, gated K8), against the same step through
              the plain paths; then the pretrain flagship R18-128, B=64,
              bf16 train step (gru_impl="pallas", nce_impl="fused",
              stem_impl and stem pool "auto"): 2 warm-up and 10 timed
              steps, with the kernels' launch counts read around the timed
              steps; nce.dense_score_6d and nce.mask_code_stats of one
              forward's pred/gt ([3072, 3072] f32) against the same
              functions on CPU copies within 1e-5; then the same step with
              nce_impl="xla", and with
              gru_impl="scan" (the per-step plain recurrence), in turns
              with it; the step with stem_impl "unfused" and "fused" in
              turns, each one's peak memory and launches (the fused stem:
              the ReLU-off K1 and K2 once a step); then the step with the
              eqroute stem (K8 must launch once a step, K2 never): its
              peak memory and clips/s in turns with the K1/K2 pool; then
              the NCE loss's forward and backward through K5/K6 and
              through the materialised score in turns at R = C of 768 to
              12288 rows, D 256 and 1024, and 1536x3072 (for
              nce_impl="auto"); and what each "auto" switch resolves to
  4. lc       the same check for one small f32 LC finetune step; then the
              LC flagship R18-128, 8x5, B=32, bf16, 101 classes: 2 warm-up
              and 10 timed finetune steps with the launch counts read
              around them, the same step with gru_impl="scan" in turns
              with it, one eval step, and the dense-test forward at window
              batch 32 in 5 windows of 10 forwards (best and spread); the
              finetune step, the eval step and the dense-test forward
              each with stem_impl "unfused" and "fused" in turns (peak
              memory, launches); then --fold_normalize off and on in
              turns with --device_augment on uint8 windows: the pretrain
              flagship step, the finetune step and the dense-test
              forward (for fold_normalize="auto")
  5. cli      python -m dpc_tpu_torch.train.pretrain for 2 synthetic steps;
              python -m dpc_tpu_torch.train.evaluate for 1 epoch of 2 steps
              plus val, then --test random on a few synthetic videos
  6. frames   both CLIs on a UCF-shaped tree of 320x240 JPEGs written with
              the port's encoder (16 videos of 150 frames, 640 train
              rows), whose split CSVs are rewritten by the port's offline
              toolkit (python -m dpc_tpu_torch.data.preprocess csv-ucf and
              classind in subprocesses, from official-format UCF lists of
              the tree's videos; rows and labels held against the tree's;
              its OpenCV extract is not run): with the host recipe, the
              pretrain flagship for 2
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
  7. tools    each tool at the pretrain flagship through its entry point,
              in a process of its own that reports its kernel launches
              (K1-K6 must launch): python -m dpc_tpu_torch.bench (one JSON
              line, its ms/step within 10% of phase 3's), bench_loop
              --source device and cached (each within 10% of the bench),
              bench_breakdown --profile (its full step within 10% of the
              bench's; every f32 convolution kernel in its profile must be
              the stem conv's, named by the launching op's shapes),
              bench_input --decode_only on the synthetic set; then in this
              process profiling.trace around two steps (the trace must name
              K1-K6), the stem conv's dtype under the bf16 step,
              enable_debug raising on a NaN input, and the pretrain CLI
              with --debug_nans for 2 steps
  8. ranks    K7 (the candidate-sharded NCE, nce_lse_rank_shard on the
              K5/K6 kernels) against its plain version at 3072x1536 and
              1536x1536, half the targets -1, and two K7 shards combined
              against K5/K6 unsharded at 3072x3072; then two ranks on the
              one card over gloo (NCCL refuses two ranks on one device),
              spawned through parallel/mesh.py: the R18-128 B64 bf16 step
              in four layouts ({data:2} local, global, cross_replica_bn;
              {data:1, model:2} global), nce_impl fused, 2 warm-up and 5
              timed steps each with the launches read around them (K1-K6,
              K7 on the model axis, on every rank), finite losses and
              bit-identical parameters across the ranks, and clips/s (two
              ranks sharing one card, not a multi-GPU rate); the same
              layouts in f32 at a small size, {data:1, model:2} held
              against one rank; the LC finetune step at the LC flagship
              (R18-128 8x5, B32 global, 16 clips a rank, bf16, dropout 0.5
              and 0.1, 101 classes) in {data:2} and {data:1, model:2}, 2
              warm-up and 5 timed steps each (K1-K4 once a step on every
              rank), bit-identical parameters and running statistics, and
              clips/s; the same in f32 at a small size, dropout off,
              {data:1, model:2} held against one rank (loss within 1e-5,
              the Adam updates' cosine at least 0.999); the dense test
              (evaluate.run_test, the LC flagship in f32, 4 synthetic
              videos) on both ranks against rank 0 alone (loss within
              1e-4, top-1 and top-5 equal); the pretrain CLI with
              --num_devices 1 --negatives global --cross_replica_bn, both
              CLIs' refusal of --num_devices 2 on one card, and the
              finetune CLI with --num_devices 2 --device cpu (one epoch
              of 2 steps and val); on both ranks, the fused stem in f32
              with its statistics over the two ranks against the fused
              stem on the whole batch (outputs, gradients, the EMA)
Then one JSON line of per-kernel results, the card's name and power limit,
and a last line {"ok": true, "device": {...}}.  Any failure exits non-zero
before the last line.  Without a CUDA device it exits 2 and prints no result.

--profile PATH writes torch.profiler tables of two pretrain and two LC
flagship steps, and the device time of each kernel inside K-GRU-F/B at the
pretrain and LC shapes, to PATH.  --rates ROOT only times the two flagship steps of
the dpc_tpu_torch under ROOT and prints one JSON line of clips/s: run it
for two checkouts in turns (a, b, b, a) in one call to compare commits.
--nccl N only runs, on N cards of one host over NCCL, one rank a card, the
pretrain step of phase 8 in its layouts, the LC step at global batch 32
in {data:N} and {data:N/2, model:2}, the dense test (evaluate.run_test
over 256 synthetic videos) on every card and on one, the pretrain CLI,
and the finetune CLI with --model_parallel 2 (4 steps and val, then
--test), and prints their clips/s and windows/s.
--cli_rates RECIPE=ROOT (repeatable) only prints the pretrain CLI's clips/s
and busy share on a frame tree with RECIPE (device_augment or host), for
this checkout and the one under ROOT in turns (ROOT, here, here, ROOT).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
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
GRU_KERNELS = ("convgru_fwd", "convgru_bwd")
NCE_KERNELS = ("nce_fwd", "nce_bwd")
STEM_FUSED = ("maxpool_fwd", "maxpool_relu_bwd")        # ReLU-off K1, K2
PRETRAIN_KERNELS = GRU_KERNELS + NCE_KERNELS + STEM_FUSED
LC_KERNELS = GRU_KERNELS + STEM_FUSED
SHARD_KERNELS = GRU_KERNELS + ("nce_fwd_shard", "nce_bwd_shard") + STEM_FUSED
# the eval step's and the dense test's (no backward)
EVAL_KERNELS = ("convgru_fwd", "maxpool_fwd")


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


def _sass(name: str) -> str:
    from dpc_tpu_torch.ops import _build

    sass = subprocess.run([_cuobjdump(), "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, timeout=300)
    expect(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
    return sass.stdout


def tensor_core_instructions(name: str) -> dict:
    """Counts of HGMMA (wgmma) and HMMA (mma.sync) in the SASS of library
    ``name``."""
    sass = _sass(name)
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA")}


def k8_instructions() -> dict:
    """Counts in the SASS of K8's vector path (the four pool_bwd_eq_tma
    instances of the maxpool library): TMA loads (UTMALDG), 128-bit
    global stores and 128-bit shared-memory loads."""
    funcs = [f for f in re.split(r"\n\s*Function : ", _sass("maxpool"))
             if "pool_bwd_eq_tma" in f.split("\n", 1)[0]]
    body = "\n".join(funcs)
    return {"functions": len(funcs),
            "UTMALDG": len(re.findall(r"\bUTMALDG\b", body)),
            "STG.128": len(re.findall(r"\bSTG\.E(?:\.\w+)*\.128\b", body)),
            "LDS.128": len(re.findall(r"\bLDS(?:\.\w+)*\.128\b", body))}


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
    k8 = k8_instructions()
    log(f"[build] maxpool SASS of K8's vector path: {k8}")
    expect(k8["functions"] == 4 and k8["UTMALDG"] > 0 and k8["STG.128"] > 0,
           "K8's vector path issues no TMA load or no 128-bit store")


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
    from dpc_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in profiling.device_events(p)
                     if e.self_device_time_total > 0),
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
    """K1, its ReLU-off instance, K2 (through either's codes) and K8
    against their plain versions at z ``shape``; both K1 instances bit for
    bit, values and codes.  On tie data K2 must route as ATen does (first
    max) and K8 must give every tied max the window's gradient."""
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
    raw_k, rcode_k = P.maxpool_fwd(z)
    raw_p, rcode_p = P.maxpool_fwd_plain(z)
    expect(torch.equal(raw_k, raw_p) and torch.equal(rcode_k, rcode_p),
           f"the ReLU-off K1 differs from its plain version at {shape} "
           f"{dtype}: {int((raw_k != raw_p).sum())} values, "
           f"{int((rcode_k != rcode_p).sum())} codes")
    expect(int(rcode_k.max()) <= 8, "the ReLU-off K1 wrote a dead code")
    rdz_k = P.maxpool_relu_bwd(gout, rcode_k)
    rdz_p = P.maxpool_relu_bwd_plain(gout, rcode_p)
    eq_k = P.maxpool_bwd_eq(z, gout)
    eq_p = P.maxpool_bwd_eq_plain(z, gout)
    eqr_k = P.maxpool_bwd_eq(z, gout, relu=True)
    eqr_p = P.maxpool_bwd_eq_plain(z, gout, relu=True)
    torch.cuda.synchronize()
    res = {"fwd": {"err": 0.0}, "fwd_raw": {"err": 0.0},
           "bwd": {"err": _grad_err("K2", dz_k, dz_p, dtype)},
           "bwd_raw": {"err": _grad_err("K2 (ReLU-off codes)", rdz_k, rdz_p,
                                        dtype)},
           "eq": {"err": _grad_err("K8", eq_k, eq_p, dtype)},
           "eq_relu": {"err": _grad_err("K8 relu", eqr_k, eqr_p, dtype)}}
    del eq_p, eqr_p
    name = (f"pool {list(shape)} {str(dtype).split('.')[-1]}"
            + (" ties" if ties else ""))
    facts = [f"K1 bit-equal ({int((code_k == P.DEAD).sum())} dead codes)",
             "ReLU-off K1 bit-equal",
             f"K2 err {res['bwd']['err']:.2e} (ReLU-off codes "
             f"{res['bwd_raw']['err']:.2e})", f"K8 err {res['eq']['err']:.2e}",
             f"K8 relu err {res['eq_relu']['err']:.2e}"]
    if z.numel() <= 2 ** 24:
        # first-max routing against ATen, in f32 on the same values (at a
        # size where normal f32 draws hold no tied window maxima)
        dz_aten = _aten_pool(z.float(), True, gout.float())
        _grad_err("K2 vs ATen", dz_k, dz_aten, dtype)
        raw_aten = _aten_pool(z.float(), False)
        expect(torch.equal(raw_k.float(),
                           raw_aten.permute(0, 2, 3, 4, 1)[:, 0]),
               "the ReLU-off K1 differs from ATen's max-pool")
        _grad_err("K2 (ReLU-off codes) vs ATen", rdz_k,
                  _aten_pool(z.float(), False, gout.float()), dtype)
        if dtype == torch.float32 and not ties:
            # bf16 draws tie within a window, where K8 gives every tied max
            # the gradient and ATen only the first
            _grad_err("K8 vs ATen", eq_k, _aten_pool(z.float(), False,
                                                     gout.float()), dtype)
            _grad_err("K8 relu vs ATen", eqr_k, dz_aten, dtype)
        facts.append("K2 routes as ATen (both codes); ReLU-off K1 equals "
                     "ATen's pool")
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
        res["fwd_raw"].update(
            ms=cuda_ms(lambda: P.maxpool_fwd(z)),
            plain_ms=cuda_ms(lambda: P.maxpool_fwd_plain(z)),
            library_ms=cuda_ms(lambda: _aten_pool(z, False)),
            bound=bound_ms(nz + no + nc, ops))
        res["bwd"].update(
            ms=cuda_ms(lambda: P.maxpool_relu_bwd(gout, code_k)),
            plain_ms=cuda_ms(lambda: P.maxpool_relu_bwd_plain(gout, code_k)),
            library_ms=cuda_ms(
                lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                    g5, zr, [1, 3, 3], [1, 2, 2], [0, 1, 1], [1, 1, 1], False,
                    idx)),
            bound=bound_ms(no + nc + nz, 4 * z.numel()))
        for key, relu in (("eq", False), ("eq_relu", True)):
            res[key].update(
                ms=cuda_ms(lambda: P.maxpool_bwd_eq(z, gout, relu)),
                plain_ms=cuda_ms(lambda: P.maxpool_bwd_eq_plain(z, gout, relu)),
                library_ms=None,
                bound=bound_ms(nz + no + nz, 9 * 2 * z.numel()))
        del zr, idx
        # a yardstick for the byte-bound kernels: a copy of z on this card
        dst = torch.empty_like(z)
        copy_ms = cuda_ms(lambda: dst.copy_(z))
        del dst
        log(f"[kernels] {name}: a copy of z {copy_ms:.3f} ms, "
            f"{2 * nz / copy_ms / 1e9:.3f} TB/s")
        for k, label in (("fwd", "K1"), ("fwd_raw", "ReLU-off K1"),
                         ("bwd", "K2"), ("eq", "K8"), ("eq_relu", "K8 relu")):
            t = res[k]
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.3f}")
            log(f"[kernels] {name}: {label} {t['ms']:.3f} ms (plain "
                f"{t['plain_ms']:.3f}, ATen {lib}, bound "
                f"{t['bound'][0]:.3f} by {t['bound'][1]})")
    return res


def check_eq(shape, dtype, ties: bool, misaligned: bool = False) -> None:
    """K8 and its ReLU-gated variant against their plain versions where K1
    and K2 do not run: a C whose pixel is not whole 16-byte vectors (the
    scalar path), or src 2 or 4 bytes off 16-byte alignment (the scalar
    path at any C)."""
    import torch
    from dpc_tpu_torch.ops import maxpool_cuda as P

    z, gout = _pool_input(shape, dtype, ties, seed=sum(shape) + 1)
    if misaligned:
        buf = torch.empty(z.numel() + 1, dtype=dtype, device=z.device)
        z = buf[1:].view(z.shape).copy_(z)
    errs = [_grad_err(f"K8{' relu' if relu else ''} at {list(shape)}",
                      P.maxpool_bwd_eq(z, gout, relu),
                      P.maxpool_bwd_eq_plain(z, gout, relu), dtype)
            for relu in (False, True)]
    log(f"[kernels] K8 {list(shape)} {str(dtype).split('.')[-1]}"
        f"{' ties' if ties else ''}{' misaligned' if misaligned else ''}: "
        f"err {errs[0]:.2e}, relu err {errs[1]:.2e}")


def check_pool_nan(dtype) -> None:
    """K1, K2 and K8 on data with NaNs: K1 (and its ReLU-off instance) gives
    NaN exactly where its plain version (``dpc_tpu``'s kernel, whose max
    propagates NaN) and ATen's (relu-then-)pool do, equal values and codes
    elsewhere, K2 routes as its plain version does, and K8 (and its gated
    variant) routes nothing from a window that holds a NaN, as its plain
    version and ``dpc_tpu``'s kernel do."""
    import torch
    from dpc_tpu_torch.ops import maxpool_cuda as P

    z, gout = _pool_input((64, 64, 64, 64), dtype, False, seed=11)
    g = torch.Generator(device=z.device).manual_seed(12)
    z.view(-1)[torch.randint(0, z.numel(), (200,), device=z.device,
                             generator=g)] = float("nan")
    out_k, code_k = P.maxpool_relu_fwd(z)
    out_p, code_p = P.maxpool_relu_fwd_plain(z)
    aten = _aten_pool(z, True).permute(0, 2, 3, 4, 1)[:, 0]
    nan_k = out_k.isnan()
    log(f"[kernels] pool NaN {str(dtype).split('.')[-1]}: "
        f"{int(nan_k.sum())} NaN windows from {int(z.isnan().sum())} NaN "
        f"inputs; K1 against plain and ATen, K2 against plain")
    expect(nan_k.any() and torch.equal(nan_k, out_p.isnan())
           and torch.equal(nan_k, aten.isnan())
           and torch.equal(out_k.nan_to_num(), out_p.nan_to_num())
           and torch.equal(code_k, code_p),
           "K1 does not propagate NaN as its plain version and ATen do")
    _grad_err("K2 on NaN data", P.maxpool_relu_bwd(gout, code_k),
              P.maxpool_relu_bwd_plain(gout, code_p), dtype)
    raw_k, rcode_k = P.maxpool_fwd(z)
    raw_p, rcode_p = P.maxpool_fwd_plain(z)
    raw_nan = raw_k.isnan()
    aten_raw = _aten_pool(z, False).permute(0, 2, 3, 4, 1)[:, 0]
    expect(raw_nan.any() and torch.equal(raw_nan, raw_p.isnan())
           and torch.equal(raw_nan, aten_raw.isnan())
           and torch.equal(raw_k.nan_to_num(), raw_p.nan_to_num())
           and torch.equal(rcode_k, rcode_p),
           "the ReLU-off K1 does not propagate NaN as its plain version "
           "and ATen do")
    _grad_err("K2 on NaN data (ReLU-off codes)",
              P.maxpool_relu_bwd(gout, rcode_k),
              P.maxpool_relu_bwd_plain(gout, rcode_p), dtype)
    for relu in (False, True):
        _grad_err(f"K8{' relu' if relu else ''} on NaN data",
                  P.maxpool_bwd_eq(z, gout, relu),
                  P.maxpool_bwd_eq_plain(z, gout, relu), dtype)
    # what a NaN-ignoring window max (F9) would have routed instead
    ignoring = P.maxpool_bwd_eq_plain(z.nan_to_num(nan=-1e30), gout)
    moved = int((ignoring != P.maxpool_bwd_eq_plain(z, gout)).sum())
    log(f"[kernels] K8 on NaN data equals its plain version; a NaN-ignoring "
        f"max would change {moved} elements of dz")
    expect(moved > 0, "the NaN data does not tell K8's NaN routing apart")


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
        check_nce(1536, 3072, 256, 0, timed=True)      # {data:2} global rank
        pool = check_pool_kernels()
        probe_stem_layout()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    return {"gru_lc": gru_lc, "nce": nce, "pool": pool}


def check_pool_kernels() -> dict:
    """The stem pool's K1, K2 and K8 (and its gated variant): timed at the
    LC and pretrain shapes, then ragged, tie, NaN, C = 20 and misaligned
    data.  Returns the LC bf16 shape's results."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    pool = check_pool((1280, 64, 64, 64), bf16, False, timed=True)  # LC
    for dt in (bf16, f32):                             # pretrain
        check_pool((2560, 64, 64, 64), dt, False, timed=True)
    check_pool((1280, 64, 64, 64), f32, False, timed=False)
    for dt in (bf16, f32):
        check_pool((37, 18, 22, 64), dt, False, timed=False)  # ragged
        check_pool((64, 64, 64, 64), dt, True, timed=False)   # ties
        check_pool_nan(dt)
        for ties in (False, True):                    # C = 20: 40 / 80 bytes
            check_eq((8, 16, 16, 20), dt, ties)
        check_eq((37, 18, 22, 64), dt, True, misaligned=True)
    return pool


# ---------------------------------------------------------------------------
# 3. the train step
# ---------------------------------------------------------------------------

def _small_step_check() -> None:
    """One f32 step at a small size through the kernels, through the
    kernels with the fused stem (the ReLU-off K1 and K2) and with the
    eqroute stem (K1 and the gated K8), and through the plain paths (scan
    GRU, materialised score, the literal stem on ATen's pool), same
    weights and batch: the losses must agree."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
    from dpc_tpu_torch.models import dpc
    from dpc_tpu_torch.ops import _build
    from dpc_tpu_torch.train import optim, pretrain_step

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = torch.randn(4, 4, 5, 64, 64, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        losses = {}
        for name, gru_impl, nce_impl, stem, stem_impl in (
                ("kernel", "pallas", "fused", "pallas", "unfused"),
                ("fused", "pallas", "fused", "pallas", "fused"),
                ("eqroute", "pallas", "fused", "eqroute", "unfused"),
                ("plain", "scan", "xla", "xla", "unfused")):
            cfg = DPCConfig(img_dim=64, num_seq=4, seq_len=5, pred_step=2,
                            gru_impl=gru_impl, gru_dropout=0.0)
            model = dpc.build_dpc(cfg, dev, seed=0)
            model.backbone.stem_pool_impl = stem
            model.backbone.stem_impl = stem_impl
            tcfg = TrainConfig(batch_size=4, nce_impl=nce_impl)
            step = pretrain_step.make_pretrain_step(
                cfg, tcfg, model, optim.pretrain_optimizer(model, 1e-3, 1e-5))
            _build.reset_launches()
            losses[name] = float(step(x)["loss"])
            if name == "eqroute":
                expect(_build.LAUNCHES["maxpool_bwd_eq"] == 1
                       and _build.LAUNCHES["maxpool_relu_bwd"] == 0,
                       f"the eqroute step did not run K8: {_build.LAUNCHES}")
            if name == "fused":
                expect(_build.LAUNCHES["maxpool_fwd"] == 1
                       and _build.LAUNCHES["maxpool_relu_bwd"] == 1
                       and _build.LAUNCHES["maxpool_relu_fwd"] == 0,
                       f"the fused stem did not run the ReLU-off K1 and K2: "
                       f"{_build.LAUNCHES}")
        errs = {k: abs(losses[k] - losses["plain"]) / abs(losses["plain"])
                for k in ("kernel", "fused", "eqroute")}
        log(f"[step] small f32 check: kernel path loss {losses['kernel']}, "
            f"fused stem {losses['fused']}, eqroute stem "
            f"{losses['eqroute']}, plain path {losses['plain']}, rel diff "
            f"{errs['kernel']:.2e} / {errs['fused']:.2e} / "
            f"{errs['eqroute']:.2e}")
        expect(max(errs.values()) <= 1e-4,
               f"kernel paths and plain path disagree: {losses}")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _close(got, want, tol: float) -> float:
    """The largest ``|got − want| − tol·|want|`` (at most ``tol`` where the
    two agree as numpy's ``assert_allclose(rtol=tol, atol=tol)`` asks)."""
    return float(((got.double() - want.double()).abs()
                  - tol * want.double().abs()).max())


def check_fused_stem(device: str = "cuda") -> dict:
    """``layers.fused_stem`` in f32 on the card (``_batch_stats``'
    Welford statistics, ``_stats_backward``, the pooled affine on ATen's
    batch-norm primitives, the ReLU-off K1 and K2) against the literal
    stem on ATen and cuDNN (conv, ``F.batch_norm``, ReLU,
    ``F.max_pool3d``), the same modules' weights: channels with γ < 0 and a
    γ = 0 channel with β = 0.7, in the three BN modes (batch statistics;
    LC train, with the EMA; eval).  Outputs to 1e-5, the gradients of x,
    the conv weight, γ (the γ = 0 channel left out: the literal stem's
    windows all tie there) and β to 2e-4, the running statistics to 1e-5
    (1e-6 absolute), as the CPU tests hold the two.  Then the pooled
    affine's forward and backward against the plain autograd expression
    ``relu(p.float()·a + b).to(p.dtype)`` at the pretrain flagship's pooled
    shape in bf16, in turns.  Returns the errors and the times.  On the
    CPU (a dry run of the check) the plain versions run and nothing is
    counted or timed."""
    import torch
    import torch.nn.functional as F
    from dpc_tpu_torch.models import layers as L
    from dpc_tpu_torch.ops import _build

    dev = torch.device(device)
    torch.backends.cudnn.allow_tf32 = False
    found = {}
    try:
        g = torch.Generator(device=dev).manual_seed(11)
        conv = torch.nn.Conv3d(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                               bias=False).to(dev)
        with torch.no_grad():
            conv.weight.normal_(0.0, 0.1, generator=g)
        x0 = torch.randn(4, 5, 64, 64, 3, device=dev, generator=g)
        ct = torch.randn(4, 64, 5, 16, 16, device=dev, generator=g)
        gamma = torch.empty(64, device=dev).uniform_(0.5, 1.5, generator=g)
        gamma[::3] *= -1
        gamma[1] = 0.0
        beta = torch.randn(64, device=dev, generator=g)
        beta[1] = 0.7
        mean0 = 0.3 * torch.randn(64, device=dev, generator=g)
        var0 = torch.empty(64, device=dev).uniform_(0.5, 2.0, generator=g)
        live = torch.arange(64, device=dev) != 1

        def unfused(c, bn, x):
            return F.max_pool3d(F.relu(bn(c(x))), (1, 3, 3), (1, 2, 2),
                                (0, 1, 1))

        for mode, track, train in (("batch", False, True),
                                   ("ema", True, True),
                                   ("eval", True, False)):
            got = {}
            for name, fn in (("fused", L.fused_stem), ("unfused", unfused)):
                bn = L.batchnorm3d(64, track_running_stats=track).to(dev)
                with torch.no_grad():
                    bn.weight.copy_(gamma)
                    bn.bias.copy_(beta)
                    if track:
                        bn.running_mean.copy_(mean0)
                        bn.running_var.copy_(var0)
                bn.train(train)
                conv.zero_grad()
                x = x0.clone().requires_grad_(True)
                _build.reset_launches()
                y = fn(conv, bn, x.permute(0, 4, 1, 2, 3))
                (y * ct).sum().backward()
                if name == "fused" and dev.type == "cuda":
                    n = dict(_build.LAUNCHES)
                    expect(n["maxpool_fwd"] == 1
                           and n["maxpool_relu_bwd"] == 1,
                           f"the fused stem ({mode}) did not run the "
                           f"ReLU-off K1 and K2: {n}")
                got[name] = {"y": y.detach(), "dx": x.grad,
                             "dw": conv.weight.grad.clone(),
                             "dgamma": bn.weight.grad[live],
                             "dbeta": bn.bias.grad,
                             "stats": [bn.running_mean, bn.running_var]
                             if track else [], "bn": bn}
            f, u = got["fused"], got["unfused"]
            err = {"y": _close(f["y"], u["y"], 1e-5)}
            for k in ("dx", "dw", "dgamma", "dbeta"):
                err[k] = _close(f[k], u[k], 2e-4)
            err["stats"] = max([float(((a.double() - b.double()).abs()
                                       - 1e-5 * b.double().abs()).max())
                                for a, b in zip(f["stats"], u["stats"])],
                               default=0.0)
            found[mode] = err
            log(f"[fused stem] f32 {mode} against the literal stem: "
                f"max(|d| − tol·|want|) {err}; dgamma[γ=0] "
                f"{float(f['bn'].weight.grad[1]):.4g} / "
                f"{float(u['bn'].weight.grad[1]):.4g}")
            expect(err["y"] <= 1e-5 and err["stats"] <= 1e-6
                   and all(err[k] <= 2e-4
                           for k in ("dx", "dw", "dgamma", "dbeta")),
                   f"the fused stem ({mode}) disagrees with the literal "
                   f"stem on the card: {err}")
            expect(abs(float(f["bn"].weight.grad[1])) > 1e-3,
                   f"the fused stem's dγ at γ = 0 is not live ({mode})")
            expect(not track or int(f["bn"].num_batches_tracked)
                   == int(u["bn"].num_batches_tracked),
                   f"num_batches_tracked differs ({mode})")
            if mode == "eval":
                expect(bool((f["bn"].running_mean == mean0).all()
                            and (f["bn"].running_var == var0).all()),
                       "the fused stem's eval mode moved the running "
                       "statistics")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    if dev.type == "cuda":
        found["affine"] = _time_pooled_affine()
    return found


def _time_pooled_affine(n: int = 20) -> dict:
    """The fused stem's pooled affine (``layers._PooledAffineRelu``: ATen's
    ``batch_norm_elemt`` forward, ``batch_norm_backward_reduce`` and
    ``batch_norm_elemt`` backward) against the plain autograd expression
    ``relu(p.float()·a + b).to(p.dtype)``, forward and backward, at the
    pretrain flagship's pooled x' ``[512, 64, 5, 32, 32]`` bf16
    channels-last-3d, in turns (plain, ATen, ATen, plain; n calls each,
    CUDA events), with each one's memory above the inputs and their
    agreement."""
    import torch
    from dpc_tpu_torch.models import layers as L

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    cl = torch.channels_last_3d
    p = torch.randn(512, 64, 5, 32, 32, device=dev, generator=g).to(
        torch.bfloat16).contiguous(memory_format=cl).requires_grad_(True)
    dy = torch.randn(p.shape, device=dev, generator=g).to(
        torch.bfloat16).contiguous(memory_format=cl)
    a = torch.rand(64, device=dev, generator=g).requires_grad_(True)
    b = torch.randn(64, device=dev, generator=g).requires_grad_(True)
    shape = (1, -1, 1, 1, 1)

    def aten():
        y = L._PooledAffineRelu.apply(p, a, b)
        return (y, *torch.autograd.grad(y, (p, a, b), dy))

    def plain():
        y = torch.relu(p.float() * a.view(shape) + b.view(shape)).to(p.dtype)
        return (y, *torch.autograd.grad(y, (p, a, b), dy))

    outs = {"aten": aten(), "plain": plain()}
    errs = [rel_err(x.detach(), w.detach())
            for x, w in zip(outs["aten"], outs["plain"])]
    expect(outs["aten"][0].is_contiguous(memory_format=cl),
           "the pooled affine's output is not channels-last-3d")
    del outs
    ms = {"plain": [], "aten": []}
    for name in ("plain", "aten", "aten", "plain"):
        ms[name].append(cuda_ms(aten if name == "aten" else plain,
                                iters=n, warmup=2))
    extra = {}
    for name, fn in (("plain", plain), ("aten", aten)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        extra[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"[fused stem] pooled affine fwd+bwd at [512, 64, 5, 32, 32] bf16: "
        f"ATen batch-norm primitives {ms['aten']} ms, plain autograd "
        f"expression {ms['plain']} ms; memory above the inputs "
        f"{extra['aten']:.3f} / {extra['plain']:.3f} GiB; rel err y, dp, "
        f"da, db {errs}")
    # bf16 y and dp: within an ulp; da, db: f32 sums in another order
    expect(max(errs[:2]) <= 2 ** -7 and max(errs[2:]) <= 1e-3,
           f"the pooled affine disagrees with its plain expression: {errs}")
    return {"ms": ms, "extra_gib": extra, "errs": errs}


def _profile(fn, path: str | None, label: str) -> None:
    """torch.profiler over two calls of ``fn``: device busy share and the
    stem pool's share of device time, and the table appended to ``path``."""
    if not path:
        return
    import torch
    from torch.profiler import ProfilerActivity, profile as prof
    from dpc_tpu_torch.utils import profiling

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t1 = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    busy_ms, busy_pct = profiling.device_busy(p, wall_ms)
    pool_ms = sum(e.self_device_time_total for e in profiling.device_events(p)
                  if "pool" in e.key.lower()) / 1e3
    summary = (f"{label}, 2 steps: wall {wall_ms:.1f} ms, device busy "
               f"{busy_ms:.1f} ms ({busy_pct:.1f}%), stem "
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
    fused_stem = check_fused_stem()
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
    check_nce_analysis(model, cfg, x)
    _profile(lambda: step(x, gen), profile, "pretrain R18-128 B=64 bf16")
    _compare_paths(cfg, tcfg, model, step, x, gen)
    stems = _stem_turns("step", model.backbone,
                        lambda: step(x, gen), batch)
    eq_launches = _eqroute_step(model, step, x, gen)
    del model, step, x
    torch.cuda.empty_cache()
    sweep = nce_sweep()
    _log_auto()
    return {"launches": launches, "eq_launches": eq_launches,
            "stem_launches": stems["launches"], "nce_sweep": sweep,
            "fused_stem": fused_stem,
            "clips_per_s": n_steps * batch / dt,
            "ms_per_step": 1e3 * dt / n_steps}


def check_nce_analysis(model, cfg, x) -> None:
    """``nce.dense_score_6d`` and ``nce.mask_code_stats`` of one flagship
    forward's pred and gt (eval mode, under the eval step's bf16 autocast)
    on the card, against the same functions on CPU copies of pred and gt:
    max |card - CPU| / max |CPU| within TOL_VALUE for the 6-D score and for
    the four means, with f32 matmul (no TF32) as ``dpc_tpu`` scores.  The
    means are logged, not ordered: the model is at init."""
    import torch
    from dpc_tpu_torch.models import dpc
    from dpc_tpu_torch.ops import nce

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = cfg.compute_dtype == "bfloat16"
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16,
                                             enabled=bf16):
            pred, gt = dpc.predict(model, x, cfg=cfg, train=False)
        b, p, s = pred.shape[:3]
        mask = nce.nce_mask(b, p, s * s)
        score = nce.dense_score_6d(pred, gt)
        stats = nce.mask_code_stats(score, mask)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu_score = nce.dense_score_6d(pred.cpu(), gt.cpu())
    cpu_stats = nce.mask_code_stats(cpu_score, mask)
    expect(tuple(score.shape) == (b, p, s * s, b, p, s * s)
           and score.dtype == torch.float32
           and bool(torch.isfinite(score).all()),
           f"dense_score_6d gave {tuple(score.shape)} {score.dtype}")
    err_score = rel_err(score.cpu(), cpu_score)
    err_means = rel_err(torch.stack([v.cpu() for v in stats.values()]),
                        torch.stack(list(cpu_stats.values())))
    means = {k: float(v) for k, v in stats.items()}
    log(f"[step] dense_score_6d {tuple(score.shape)} and mask_code_stats "
        f"of one flagship forward on the card against the CPU: score "
        f"{err_score:.2e}, means {err_means:.2e} (tol {TOL_VALUE}); means "
        f"{means}")
    expect(err_score <= TOL_VALUE and err_means <= TOL_VALUE,
           f"the NCE analysis helpers on the card are off the CPU's: "
           f"score {err_score:.2e}, means {err_means:.2e}")


def _stem_turns(what: str, bb, run, batch: int, n_steps: int = 5,
                grads: bool = True) -> dict:
    """``run()`` (a step or a forward of the model whose backbone is
    ``bb``) with ``stem_impl`` "unfused" and "fused": each one's peak
    memory, the launches of n_steps calls of each (fused: the ReLU-off K1
    once a call and K1 never, unfused the other way round; K2 once a call
    when ``grads``), and clips/s in turns (unfused, fused, fused,
    unfused).  Restores ``bb.stem_impl``."""
    import torch
    from dpc_tpu_torch.ops import _build

    before = bb.stem_impl

    def with_stem(impl):
        bb.stem_impl = impl
        return run()

    try:
        peak = {}
        for impl in ("unfused", "fused"):
            with_stem(impl)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with_stem(impl)
            torch.cuda.synchronize()
            peak[impl] = torch.cuda.max_memory_allocated() / 2**30
        launches = {}
        for impl, fwd, other in (("unfused", "maxpool_relu_fwd",
                                  "maxpool_fwd"),
                                 ("fused", "maxpool_fwd", "maxpool_relu_fwd")):
            _build.reset_launches()
            for _ in range(n_steps):
                with_stem(impl)
            torch.cuda.synchronize()
            n = launches[impl] = dict(_build.LAUNCHES)
            expect(n[fwd] == n_steps and n[other] == 0
                   and n["maxpool_relu_bwd"] == (n_steps if grads else 0),
                   f"the {impl} stem ({what}) did not launch {fwd}"
                   f"{' and K2' if grads else ''} once a call: {n}")
        rates = _in_turns(lambda: with_stem("unfused"),
                          lambda: with_stem("fused"), batch)
    finally:
        bb.stem_impl = before
    log(f"[{what}] stem in turns: unfused {rates['plain']} clips/s, fused "
        f"{rates['kernel']} clips/s; peak {peak['unfused']:.2f} / "
        f"{peak['fused']:.2f} GiB; launches over {n_steps} calls "
        f"{launches}")
    return {"launches": launches, "rates": rates, "peak_gib": peak}


# the F10 sweep of the NCE loss: (rows, candidates, D); R = C over the
# pretrain batch sizes 16-256 (pred 3 x 4x4 cells), R18's D=256 and R50's
# D=1024, and a rank's tile of {data:2} global negatives
NCE_SWEEP = [(r, r, d) for d in (256, 1024) for r in (768, 3072, 6144, 12288)
             ] + [(1536, 3072, 256)]


def nce_sweep(n: int = 20) -> list:
    """NCE forward and backward of the loss through the flash kernels (K5,
    K6) and through the materialised score (the step's nce_impl="xla"
    path), in turns (materialised, flash, flash, materialised; n calls
    each, CUDA events), at each NCE_SWEEP shape: for nce_impl="auto"."""
    import torch
    from dpc_tpu_torch.ops import nce, nce_cuda

    found = []
    for r, c, d in NCE_SWEEP:
        rows, cols, _ = _nce_case(r, c, d, r + c + d)
        targets = (torch.arange(r, device=rows.device) % c).int()
        rows.requires_grad_(True)
        cols.requires_grad_(True)

        def flash():
            lse, pos, _ = nce_cuda.nce_lse_rank(rows, cols, targets)
            (lse - pos).mean().backward()

        def plain():
            nce.nce_loss(rows @ cols.t(), targets)[0].backward()

        ms = {"xla": [], "fused": []}
        for name, fn in (("xla", plain), ("fused", flash)) * 2:
            fn()
        for name, fn in (("xla", plain), ("fused", flash), ("fused", flash),
                         ("xla", plain)):
            ms[name].append(cuda_ms(fn, iters=n, warmup=1))
        peak = {}
        for name, fn in (("xla", plain), ("fused", flash)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
        row = {"rows": r, "cols": c, "d": d, "xla_ms": ms["xla"],
               "fused_ms": ms["fused"], "xla_extra_mib": peak["xla"],
               "fused_extra_mib": peak["fused"],
               "faster": ("fused" if min(ms["fused"]) < min(ms["xla"])
                          else "xla"),
               "auto": nce.pick_nce_impl(r, c, d, rows.device)}
        found.append(row)
        log(f"[nce sweep] {r}x{c} D={d}: fwd+bwd materialised "
            f"{ms['xla']} ms, flash {ms['fused']} ms; extra memory "
            f"{peak['xla']:.1f} / {peak['fused']:.1f} MiB; faster "
            f"{row['faster']}, auto {row['auto']}")
        del rows, cols
    return found


def _log_auto() -> None:
    """What each "auto" switch resolves to on this card at the
    flagships."""
    import torch
    from dpc_tpu_torch.core.config import EvalConfig, TrainConfig
    from dpc_tpu_torch.data import device_augment
    from dpc_tpu_torch.models.resnet2d3d import resolve_stem_impl
    from dpc_tpu_torch.ops import nce

    dev = torch.device("cuda")
    fold = {name: device_augment.resolve_fold(c, dense)[0] for name, c, dense
            in (("pretrain", TrainConfig(device_augment=True), False),
                ("finetune", EvalConfig(device_augment=True), False),
                ("dense_test", EvalConfig(device_augment=True), True))}
    log(f"[auto] on {torch.cuda.get_device_name(0)}: stem_impl "
        f"{resolve_stem_impl('auto', torch.empty(0, device=dev))}; "
        f"nce_impl at the pretrain flagship (3072x3072, "
        f"D=256) {nce.pick_nce_impl(3072, 3072, 256, dev)}, at R50's "
        f"D=1024 {nce.pick_nce_impl(3072, 3072, 1024, dev)}; "
        f"fold_normalize with --device_augment {fold}")


def _eqroute_step(model, step, x, gen, n_steps: int = 5) -> dict:
    """The flagship step with the eqroute stem (K1 forward, K8 gated by
    z > 0 backward, z saved): K1 and K8 once a step and K2 never, finite
    losses, its peak memory and clips/s in turns with the default stem.
    Returns its launch counts."""
    import torch
    from dpc_tpu_torch.ops import _build

    bb, batch = model.backbone, x.shape[0]
    stem_before = bb.stem_impl
    bb.stem_impl = "unfused"     # stem_pool_impl is the literal stem's

    def run(impl):
        bb.stem_pool_impl = impl
        return step(x, gen)

    try:
        peak = {}
        for impl in ("auto", "eqroute"):
            run(impl)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run(impl)
            torch.cuda.synchronize()
            peak[impl] = torch.cuda.max_memory_allocated() / 2**30
        _build.reset_launches()
        metrics = [run("eqroute") for _ in range(n_steps)]
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        losses = [float(m["loss"]) for m in metrics]
        log(f"[step] eqroute stem: launches over {n_steps} steps {launches}; "
            f"losses {losses}")
        expect(launches["maxpool_bwd_eq"] == n_steps
               and launches["maxpool_relu_fwd"] == n_steps
               and launches["maxpool_relu_bwd"] == 0,
               f"the eqroute step did not launch K1 and K8 once a step and "
               f"K2 never: {launches}")
        expect(all(math.isfinite(v) for v in losses),
               f"non-finite eqroute loss {losses}")
        rates = _in_turns(lambda: run("auto"), lambda: run("eqroute"), batch)
    finally:
        bb.stem_pool_impl = "auto"
        bb.stem_impl = stem_before
    log(f"[step] stem pool in turns: K1/K2 {rates['plain']} clips/s, "
        f"eqroute (K1/K8) {rates['kernel']} clips/s; peak "
        f"{peak['auto']:.2f} / {peak['eqroute']:.2f} GiB")
    return launches


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
    """One f32 LC finetune step at a small size, same weights, batch and
    labels, dropout off: through the kernels with the stem "auto" resolves
    to (fused: the ReLU-off K1 and K2), through the kernels with the
    unfused stem (K1-K4), and through the plain paths (the unfused stem on
    ATen's pool, scan GRU).  The losses and the updated running statistics
    of each kernel path must agree with the plain path's."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, EvalConfig
    from dpc_tpu_torch.models import lc
    from dpc_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(4, 4, 5, 64, 64, 3, device=dev, generator=g)
        y = torch.randint(0, 11, (4,), device=dev, generator=g)
        ecfg = EvalConfig(num_classes=11, dropout=0.0, batch_size=4)
        loss, stats = {}, {}
        for name, gru_impl, pool, stem_impl in (
                ("auto", "pallas", "pallas", "auto"),
                ("unfused", "pallas", "pallas", "unfused"),
                ("plain", "scan", "xla", "unfused")):
            cfg = DPCConfig(img_dim=64, num_seq=4, seq_len=5,
                            gru_impl=gru_impl, gru_dropout=0.0)
            model, step = _lc_parts(cfg, ecfg)
            model.backbone.stem_pool_impl = pool
            model.backbone.stem_impl = stem_impl
            _build.reset_launches()
            loss[name] = float(step(x, y)["loss"])
            if name == "auto":
                expect(_build.LAUNCHES["maxpool_fwd"] == 1
                       and _build.LAUNCHES["maxpool_relu_bwd"] == 1
                       and _build.LAUNCHES["maxpool_relu_fwd"] == 0,
                       f"the LC step under stem_impl='auto' did not run the "
                       f"fused stem's kernels: {_build.LAUNCHES}")
            stats[name] = torch.cat([v.flatten()
                                     for v in lc.running_stats(model).values()])
        err = {k: abs(loss[k] - loss["plain"]) / abs(loss["plain"])
               for k in ("auto", "unfused")}
        serr = {k: rel_err(stats[k], stats["plain"])
                for k in ("auto", "unfused")}
        log(f"[lc] small f32 check: kernel path loss {loss['auto']} (fused "
            f"stem), {loss['unfused']} (unfused stem), plain path "
            f"{loss['plain']}, rel diff {err['auto']:.2e} / "
            f"{err['unfused']:.2e}; running stats rel diff "
            f"{serr['auto']:.2e} / {serr['unfused']:.2e}")
        expect(max(err.values()) <= 1e-4 and max(serr.values()) <= 1e-4,
               f"LC kernel paths and plain path disagree: {loss}, {serr}")
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
    del scan_step, opt
    stems = {"train": _stem_turns("lc", model.backbone,
                                  lambda: step(x, y, gen), batch)}

    eval_step = finetune_step.make_finetune_eval_step(cfg, ecfg, model)
    val = {k: float(v) for k, v in eval_step(x, y).items()}
    log(f"[lc] eval step: {val}")
    expect(all(math.isfinite(v) for v in val.values()), f"eval {val}")
    stems["eval"] = _stem_turns("lc eval", model.backbone,
                                lambda: eval_step(x, y), batch, grads=False)

    # the dense-test forward: 5 windows of 10 forwards, for its spread
    wb, n_fwd = 32, 10
    forward = finetune_step.make_test_forward(cfg, ecfg, model)
    windows = torch.randn(wb, cfg.num_seq, cfg.seq_len, cfg.img_dim,
                          cfg.img_dim, 3, device=dev, generator=gen)
    for _ in range(2):
        forward(windows)
    torch.cuda.synchronize()
    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        logits = [forward(windows) for _ in range(n_fwd)]
        torch.cuda.synchronize()
        rates.append(n_fwd * wb / (time.perf_counter() - t0))
    rates.sort()
    log(f"[lc] dense-test forward WB={wb}: {rates[-1]:.2f} windows/s best "
        f"of 5 windows of {n_fwd} ({1e3 * wb / rates[-1]:.1f} ms/forward); "
        f"windows {[round(r, 2) for r in rates]}, spread "
        f"{100 * (rates[-1] - rates[0]) / rates[-1]:.1f}%")
    expect(logits[-1].shape == (wb, classes)
           and bool(torch.isfinite(logits[-1]).all()), "dense-test logits")
    stems["dense"] = _stem_turns("lc dense test", model.backbone,
                                 lambda: forward(windows), wb, grads=False)
    del model, step, eval_step, forward, windows, x, logits
    torch.cuda.empty_cache()
    fold = fold_turns()
    return {"launches": launches, "dense_test_windows_per_s": rates,
            "stems": stems, "fold": fold}


def fold_turns() -> dict:
    """``--fold_normalize`` on and off with ``--device_augment``, in turns
    (off, on, on, off; 5 calls each) on device-resident uint8 windows of
    the recipes' geometry (UCF101 at 128): the pretrain flagship step (its
    recipe inside the step), the LC finetune step, and the dense-test
    forward (centre crop): for fold_normalize="auto"."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, EvalConfig, TrainConfig
    from dpc_tpu_torch.data import device_augment
    from dpc_tpu_torch.models import dpc, lc
    from dpc_tpu_torch.train import finetune_step, optim, pretrain_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    found = {}

    def windows(b, task):
        h, w = device_augment.device_augment_geometry("ucf101", 128, task)[1]
        return torch.randint(0, 256, (b, 8, 5, h, w, 3), device=dev,
                             dtype=torch.uint8, generator=gen)

    def turns(name, make, batch):
        off, on = make("off"), make("on")
        found[name] = _in_turns(off, on, batch)
        log(f"[fold] {name}: fold off {found[name]['plain']}, on "
            f"{found[name]['kernel']} clips/s")

    cfg = DPCConfig(compute_dtype="bfloat16", gru_impl="pallas")
    model = dpc.build_dpc(cfg, dev, seed=0)
    opt = optim.pretrain_optimizer(model, 1e-3, 1e-5)
    u8 = windows(64, "pretrain")
    agen = torch.Generator().manual_seed(0)

    def pre(fold):
        tcfg = TrainConfig(batch_size=64, nce_impl="fused",
                           device_augment=True, fold_normalize=fold)
        step = pretrain_step.make_pretrain_step(cfg, tcfg, model, opt)
        return lambda: step(u8, gen, agen)

    turns("pretrain step", pre, 64)
    del model, opt, u8
    torch.cuda.empty_cache()

    lcfg = DPCConfig(compute_dtype="bfloat16", gru_impl="pallas",
                     gru_dropout=0.1)
    base = dict(num_classes=101, dropout=0.5, train_what="ft",
                backbone_lr_scale=0.1, batch_size=32, device_augment=True)
    model = lc.build_lc(lcfg, 101, dev, dropout=0.5, seed=0)
    opt = optim.finetune_optimizer(model, 1e-3, 1e-3, "ft", 0.1)
    u8 = windows(32, "finetune")
    y = torch.randint(0, 101, (32,), device=dev, generator=gen)

    def ft(fold):
        step = finetune_step.make_finetune_step(
            lcfg, EvalConfig(**base, fold_normalize=fold), model, opt)
        return lambda: step(u8, y, gen, augment_gen=agen)

    turns("finetune step", ft, 32)
    u8 = windows(32, "test")

    def dense(fold):
        forward = finetune_step.make_test_forward(
            lcfg, EvalConfig(**base, fold_normalize=fold), model)
        return lambda: forward(u8)

    turns("dense-test forward", dense, 32)
    del model, opt, u8
    torch.cuda.empty_cache()
    return found


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
                   "test cli", EVAL_KERNELS)
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


def _loader_rate(ds, batch: int, workers: int, mode: str,
                 n_batches: int) -> float:
    """clips/s of a ClipLoader alone (no device work, batches pinned as
    the CLIs pin them), measured by ``bench_input.loader_rate``: one batch
    warms the pool (a process pool's first batch waits for the workers to
    start), then ``n_batches`` are timed."""
    from dpc_tpu_torch.data.loader import ClipLoader
    from dpc_tpu_torch.train import bench_input

    loader = ClipLoader(ds, batch, num_workers=workers, worker_mode=mode,
                        seed=0, pin_memory=True)
    try:
        return bench_input.loader_rate(loader, n_batches)
    finally:
        loader.close(wait=True)  # the next measurement wants the cores


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
            EVAL_KERNELS)
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
    for mode in ("thread", "process"):
        key = f"da_loader_{mode}_clips_per_s"
        rates[key] = _loader_rate(ds, batch, workers, mode, 5)
        log(f"[frames] loader alone with the host half, {mode} mode, "
            f"{workers} workers, B={batch}, 5 batches after one: "
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


def preprocess_splits(base: Path, num_frames: int) -> None:
    """Replace the frame tree's split CSVs under ``base`` with ones the
    port's offline toolkit writes.  The tree's videos go into official UCF
    lists (``trainlist01.txt`` with labels, ``testlist01.txt`` without),
    in the order and multiplicity of the rows of its split CSVs; then
    ``python -m dpc_tpu_torch.data.preprocess csv-ucf`` and ``classind``
    run in subprocesses.  Their rows must equal the tree's (the same dirs,
    ``num_frames`` frames each), and the written ``classInd.txt`` must give
    each class dir of the tree its label.  The tree keeps its own 101-name
    ``classInd.txt``.  The toolkit's ``extract`` is not run: it decodes
    video with OpenCV, which this script does not import."""
    from dpc_tpu_torch.data import video_dataset

    frame_root = base / "frame"
    lists, out = base / "ucfTrainTestlist", base / "preprocessed"
    lists.mkdir()
    labels = video_dataset.read_class_index(str(base / "classInd.txt"))
    want = {}
    for part, listname in (("train", "trainlist01.txt"),
                           ("test", "testlist01.txt")):
        want[part] = video_dataset.read_split_csv(
            str(base / f"{part}_split01.csv"))
        lines = []
        for vdir, _ in want[part]:
            rel = Path(vdir).relative_to(frame_root)
            label = f" {labels[rel.parts[0]] + 1}" if part == "train" else ""
            lines.append(f"{rel.as_posix()}.avi{label}\n")
        (lists / listname).write_text("".join(lines))
    t0 = time.perf_counter()
    for argv in (["csv-ucf", str(lists), str(frame_root), str(out),
                  "--split", "1"],
                 ["classind", str(frame_root), str(out / "classInd.txt")]):
        res = subprocess.run(
            [sys.executable, "-m", "dpc_tpu_torch.data.preprocess", *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        expect(res.returncode == 0,
               f"preprocess {argv[0]} exited {res.returncode}: "
               f"{res.stderr[-2000:]}")
        log(f"[frames] python -m dpc_tpu_torch.data.preprocess {argv[0]}: "
            f"{' / '.join(res.stdout.strip().splitlines()) or 'done'}")
    for part in ("train", "test"):
        got = video_dataset.read_split_csv(str(out / f"{part}_split01.csv"))
        expect(got == want[part] and all(n == num_frames for _, n in got),
               f"the toolkit's {part} CSV ({len(got)} rows) differs from "
               f"the tree's ({len(want[part])} rows)")
    got_labels = video_dataset.read_class_index(str(out / "classInd.txt"))
    classes = sorted(p.name for p in frame_root.iterdir())
    expect(sorted(got_labels) == classes
           and all(got_labels[c] == labels[c] for c in classes),
           f"the toolkit's classInd.txt {got_labels} gives the tree's "
           f"classes other labels")
    for part in ("train", "test"):
        shutil.copy(out / f"{part}_split01.csv", base / f"{part}_split01.csv")
    opencv = importlib.util.find_spec("cv2") is not None
    log(f"[frames] split CSVs from the port's preprocess ({len(want['train'])}"
        f" train / {len(want['test'])} test rows, {len(classes)} classes "
        f"labelled as the tree's) in {time.perf_counter() - t0:.1f} s; the "
        "CLIs below read them; the toolkit's extract is not run here "
        f"(OpenCV {'installed' if opencv else 'not installed'} on this "
        "machine; this script imports none)")


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
        n_frames = tree_kw["num_videos"] * tree_kw["num_frames"]
        log(f"[frames] wrote {n_frames} JPEG frames of "
            f"{tree_kw['width']}x{tree_kw['height']} in "
            f"{time.perf_counter() - t0:.1f} s")
        preprocess_splits(base, tree_kw["num_frames"])
        rows = (base / "test_split01.csv").read_text().splitlines()
        (base / "test_split02.csv").write_text("\n".join(rows[:16]) + "\n")
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
            "frames test", EVAL_KERNELS)
        top1 = [ln for ln in out.splitlines() if ln.startswith("[test] loss")]
        expect(bool(top1) and "top1" in top1[0] and "16 videos" in out,
               "the dense test of the finetune run printed no top1")

        # the feed alone
        train_ds = pretrain.get_dataset(
            pretrain.config_from_args(pretrain.build_parser().parse_args(
                [*data, *pre_args])), "train")
        batch = int(pre_args[pre_args.index("--batch_size") + 1])
        for mode in ("thread", "process"):
            rates[f"loader_{mode}_clips_per_s"] = _loader_rate(
                train_ds, batch, workers, mode, 2)
            log(f"[frames] loader alone, {mode} mode, {workers} workers, "
                f"B={batch}, 2 batches after one: "
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
# 7. the bench, profiling and debug tools
# ---------------------------------------------------------------------------

TOOL_TOL = 0.10  # the bench's and the breakdown's step against phase 3's
# the CUDA kernel each launch counter's wrapper runs, as a trace names it
TRACE_NAMES = {"maxpool_relu_fwd": "pool_fwd_kernel",
               "maxpool_fwd": "pool_fwd_kernel",
               "maxpool_relu_bwd": "pool_bwd_kernel",
               "convgru_fwd": "gru_fwd_scan", "convgru_bwd": "gru_bwd_scan",
               "nce_fwd": "nce_fwd_kernel", "nce_bwd": "nce_bwd_kernel"}


def _run_tool(module: str, argv: list, what: str, kernels=()) -> list:
    """``python -m module argv`` in a process of its own, with its kernel
    launch counts reported on stderr by a wrapper that runs the module as
    ``__main__``; logs its output, fails if it fails or a kernel of
    ``kernels`` did not launch, and returns its stdout's lines."""
    code = ("import json, runpy, sys\n"
            "from dpc_tpu_torch.ops import _build\n"
            f"sys.argv = {[module, *argv]!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__', "
            "alter_sys=True)\n"
            "print('LAUNCHES ' + json.dumps(_build.LAUNCHES), "
            "file=sys.stderr)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        log(f"[tools] {what}: {line}")
    expect(proc.returncode == 0,
           f"{what} failed ({proc.returncode}): {proc.stderr[-3000:]}")
    found = re.findall(r"^LAUNCHES (.*)$", proc.stderr, re.M)
    launches = json.loads(found[-1])
    log(f"[tools] {what}: {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")
    expect(all(launches[k] > 0 for k in kernels),
           f"a kernel did not run in {what}: {launches}")
    return lines


def _check_stem_conv_profile(rows: list) -> None:
    """The breakdown's profile names every f32 convolution kernel by the op
    that ran it: each must be the stem conv (3 input channels), whose
    inputs cuDNN converts from bf16 (the conversion kernels of the same
    op say so)."""
    f32 = [r for r in rows if "f32f32_f32f32" in r["kernel"]]
    if not f32:
        log("[tools] breakdown profile: no f32 convolution kernel")
    for r in f32:
        log(f"[tools] f32 kernel {r['kernel'][:100]}: {r['ms'] / 2:.3f} "
            f"ms/step x{r['count'] // 2}, launched by {r['op']} on "
            f"{r['shapes'][:2]}")
        stem = r["shapes"][0][1] == 3 and r["shapes"][1][1:] == [3, 1, 7, 7]
        expect(r["op"] == "aten::cudnn_convolution" and stem,
               f"an f32 kernel that is not the stem conv's: {r}")
        conv = [c for c in rows if c["op"] == r["op"]
                and c["shapes"] == r["shapes"] and c is not r]
        for c in conv:
            log(f"[tools]   with {c['kernel'][:100]}: {c['ms'] / 2:.3f} "
                f"ms/step")
        expect(any("__nv_bfloat16" in c["kernel"] for c in conv),
               "the f32 stem conv's inputs are not bf16")


def _trace_and_debug(tmp: Path) -> dict:
    """``profiling.trace`` around two flagship steps: its Chrome trace must
    name K1-K6; the stem conv's output dtype under the bf16 step; and
    ``enable_debug`` on the card: a NaN in the input raises in the step."""
    import torch
    import torch.nn.functional as F
    from dpc_tpu_torch import bench
    from dpc_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    cfg, tcfg, model, step = bench.flagship(dev)
    x = torch.from_numpy(bench.flagship_batch(cfg, tcfg)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    seen = []
    conv3d = F.conv3d          # the step's first conv3d is the stem conv's

    def spy(inp, *args, **kwargs):
        out = conv3d(inp, *args, **kwargs)
        seen.append((inp.dtype, out.dtype))
        return out

    F.conv3d = spy
    try:
        step(x, gen)
    finally:
        F.conv3d = conv3d
    log(f"[tools] stem conv under the bf16 step: input {seen[0][0]}, "
        f"computes in {seen[0][1]} (weights "
        f"{model.backbone.conv1.weight.dtype})")
    expect(seen[0][1] == torch.bfloat16, f"the stem conv ran in {seen[0][1]}")
    with profiling.trace(str(tmp / "trace")):
        for _ in range(2):
            step(x, gen)
    (path,) = (tmp / "trace").glob("*.pt.trace.json")
    names = {e.get("name", "") for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "kernel"}
    found = {k: any(TRACE_NAMES[k] in n for n in names)
             for k in PRETRAIN_KERNELS}
    log(f"[tools] profiling.trace of 2 steps: "
        f"{path.stat().st_size / 2**20:.1f} MiB, {len(names)} kernel names; "
        f"the port's kernels: {found}")
    expect(all(found.values()), f"the trace misses a kernel: {found}")
    del model, step, x
    torch.cuda.empty_cache()

    cfg, tcfg, model, step = bench.flagship(dev, batch_size=4, img_dim=64)
    bad = torch.randn(4, cfg.num_seq, cfg.seq_len, 64, 64, 3, device=dev)
    bad[0, 0, 0, 0, 0, 0] = float("nan")
    profiling.enable_debug(nan_checks=True)
    try:
        step(bad, gen)
        raised = None
    except (FloatingPointError, RuntimeError) as e:
        raised = e
    finally:
        profiling.disable_debug()
    log(f"[tools] enable_debug, a NaN in the input: {raised!r}")
    expect(isinstance(raised, FloatingPointError),
           "enable_debug let a NaN loss through")
    return {"trace_kernels": found}


def phase_tools(step_ms: float) -> dict:
    """The port's bench, profiling and debug tools on the card at the
    pretrain flagship, each through its entry point: the bench (one JSON
    line, its step within TOOL_TOL of phase 3's), the CLIs' epoch loop on a
    device-resident and on a cached host batch (each within TOOL_TOL of the
    bench), the breakdown (its full
    step within TOOL_TOL of the bench's; its profile names the f32
    convolution), the host feed alone on the synthetic set, a trace of two
    steps, and the pretrain CLI with --debug_nans."""
    from dpc_tpu_torch.train import pretrain

    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        lines = _run_tool("dpc_tpu_torch.bench", [], "bench",
                          PRETRAIN_KERNELS)
        expect(len(lines) == 1, f"bench printed {len(lines)} lines, not one")
        b = json.loads(lines[0])
        gap = abs(b["ms_per_step"] - step_ms) / step_ms
        log(f"[tools] bench: {b['value']} clips/s best window, windows "
            f"{b['windows']}, spread {b['spread_pct']}%, {b['ms_per_step']} "
            f"ms/step against phase 3's {step_ms:.2f} ({100 * gap:.1f}% "
            f"apart), peak {b['peak_mem_mib']} MiB, {b['device']}")
        expect(b["value"] > 0 and gap <= TOOL_TOL,
               f"bench's step is {100 * gap:.1f}% off phase 3's")
        out["bench"] = b
        for source in ("device", "cached"):
            r = json.loads(_run_tool(
                "dpc_tpu_torch.train.bench_loop", ["--source", source],
                f"bench_loop {source}", PRETRAIN_KERNELS)[-1])
            out[f"loop_{source}"] = r
            gap = 1 - r["value"] / b["value"]
            log(f"[tools] bench_loop --source {source}: {r['value']} "
                f"clips/s, {r['ms_per_step']} ms/step, {100 * gap:.1f}% "
                "below the bench")
            # the one-deep drain hides the loop's host work, and the copy
            # of a cached batch behind the step before
            expect(r["steps"] == 40 and gap <= TOOL_TOL,
                   f"bench_loop --source {source} is {100 * gap:.1f}% below "
                   f"the bench: {r}")
        prof = tmp / "breakdown.txt"
        d = json.loads(_run_tool(
            "dpc_tpu_torch.train.bench_breakdown", ["--profile", str(prof)],
            "bench_breakdown", PRETRAIN_KERNELS)[-1])
        out["breakdown"] = d
        gap = abs(d["full_step"] - b["ms_per_step"]) / b["ms_per_step"]
        log(f"[tools] bench_breakdown: full_step {d['full_step']} ms against "
            f"the bench's {b['ms_per_step']} ({100 * gap:.1f}% apart)")
        expect(gap <= TOOL_TOL, f"the breakdown's full step is "
                                f"{100 * gap:.1f}% off the bench's")
        _check_stem_conv_profile(json.loads(Path(
            str(prof) + ".json").read_text())["rows"])
        r = json.loads(_run_tool(
            "dpc_tpu_torch.train.bench_input",
            ["--decode_only", "--batches", "2"], "bench_input")[-1])
        out["input"] = r
        expect(r["value"] > 0, f"bench_input {r}")
        out.update(_trace_and_debug(tmp))
    cli = _run_cli(pretrain.main,
                   ["--dataset", "synthetic", "--nce_impl", "fused",
                    "--batch_size", "8", "--epochs", "1",
                    "--steps_per_epoch", "2", "--num_workers", "4",
                    "--print_freq", "1", "--debug_nans"],
                   "debug_nans cli", PRETRAIN_KERNELS)
    import torch
    expect("[epoch 0] 2 train steps" in cli and not torch.is_anomaly_enabled(),
           "the --debug_nans CLI did not run 2 steps, or left anomaly mode on")
    return out


# ---------------------------------------------------------------------------
# 8. ranks: K7, and the pretrain step on two ranks that share the card
# ---------------------------------------------------------------------------

# the full-width layouts on two ranks: (name, model axis, TrainConfig fields)
RANK_LAYOUTS = (
    ("data2_local", 1, dict(negatives="local")),
    ("data2_global", 1, dict(negatives="global")),
    ("data2_xbn", 1, dict(negatives="local", cross_replica_bn=True)),
    ("data1_model2", 2, dict(negatives="global")),
)
RANK_STEPS = 5


def _nce_case(r, c, d, seed, device: str = "cuda"):
    import torch

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = 0.25 * torch.randn(r, d, device=dev, generator=g)
    cols = 0.25 * torch.randn(c, d, device=dev, generator=g)
    return rows, cols, g


def check_nce_shard(r, c, d, timed: bool, device: str = "cuda") -> dict:
    """K7 against its plain version at a candidate shard's shape, with the
    positive on this shard for half the rows and -1 (another shard's) for
    the others: lse, rank, drows, dcols; the gradient for pos is 0."""
    import torch
    from dpc_tpu_torch.ops import nce_cuda as N

    rows, cols, g = _nce_case(r, c, d, r + 2 * c, device)
    t = torch.arange(r, device=rows.device) % c
    owned = torch.arange(r, device=rows.device) % 2 == 0
    targets = torch.where(owned, t, -1).int()
    # the positive of an odd row lies on another shard
    other = 0.25 * torch.randn(r, d, device=rows.device, generator=g)
    pos = torch.where(owned, (rows * cols[t]).sum(-1),
                      (rows * other).sum(-1))
    gl = torch.randn(r, device=rows.device, generator=g) / r
    got, want = {}, {}
    for out, fn in ((got, N.nce_lse_rank_shard),
                    (want, N.nce_lse_rank_shard_plain)):
        a, b = rows.clone().requires_grad_(), cols.clone().requires_grad_()
        p = pos.clone().requires_grad_()
        lse, rank = fn(a, b, p, targets)
        (lse * gl).sum().backward()
        out.update(lse=lse.detach(), rank=rank, drows=a.grad, dcols=b.grad,
                   dpos=p.grad)
    rank_diff = (got["rank"] - want["rank"]).abs()
    n_rank = int((rank_diff > 0).sum())
    errs = {k: rel_err(got[k], want[k]) for k in ("lse", "drows", "dcols")}
    log(f"[ranks] K7 R={r} C={c} D={d}, half the targets -1: rel err "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; rank differs on {n_rank} rows (max "
        f"{float(rank_diff.max()):.0f}); |dpos| "
        f"{float(got['dpos'].abs().max()):.1e}")
    expect(errs["lse"] <= TOL_VALUE, f"K7 lse disagrees: {errs}")
    expect(n_rank <= RANK_ROWS * r and float(rank_diff.max()) <= 2,
           f"K7 rank disagrees on {n_rank} rows")
    expect(errs["drows"] <= TOL_GRAD and errs["dcols"] <= TOL_GRAD,
           f"K7's backward disagrees: {errs}")
    expect(float(got["dpos"].abs().max()) == 0.0, "K7 gives pos a gradient")
    res = {"fwd_err": float((got["lse"] - want["lse"]).abs().max()),
           "bwd_err": max(float((got[k] - want[k]).abs().max())
                          for k in ("drows", "dcols"))}
    if timed:
        lse_p = want["lse"]
        fwd_bytes, fwd_ops = 4 * ((r + c) * d + 4 * r), 2 * r * c * d
        bwd_bytes, bwd_ops = 4 * (2 * (r + c) * d + 2 * r), 6 * r * c * d
        res["fwd"] = dict(
            ms=cuda_ms(lambda: N.nce_forward(rows, cols, pos, targets,
                                             count_as="nce_fwd_shard")),
            plain_ms=cuda_ms(lambda: N.nce_forward_plain(rows, cols, pos,
                                                         targets)),
            library_ms=cuda_ms(lambda: torch.logsumexp(rows @ cols.t(), -1)),
            bound=bound_ms(fwd_bytes, 3 * fwd_ops, TF32_FLOPS))
        res["bwd"] = dict(
            ms=cuda_ms(lambda: N.nce_backward(rows, cols, lse_p, gl,
                                              count_as="nce_bwd_shard")),
            plain_ms=cuda_ms(lambda: N.nce_backward_plain(rows, cols, lse_p,
                                                          gl)),
            library_ms=None,
            bound=bound_ms(bwd_bytes, 3 * bwd_ops, TF32_FLOPS))
        log(f"[ranks] K7 R={r} C={c} D={d}: fwd {res['fwd']['ms']:.3f} ms "
            f"(plain {res['fwd']['plain_ms']:.3f}, matmul+logsumexp "
            f"{res['fwd']['library_ms']:.3f}, bound "
            f"{res['fwd']['bound'][0]:.4f} 3xTF32); bwd "
            f"{res['bwd']['ms']:.3f} ms (plain {res['bwd']['plain_ms']:.3f}, "
            f"bound {res['bwd']['bound'][0]:.4f} 3xTF32)")
    return res


def check_shard_combine(n: int = 3072, d: int = 256,
                        device: str = "cuda") -> None:
    """Two K7 shards combined (logsumexp of their lse, sum of their ranks)
    against K5/K6 unsharded at n²: loss, top-k and both gradients."""
    import torch
    from dpc_tpu_torch.ops import nce_cuda as N

    rows, cols, _ = _nce_case(n, n, d, 7, device)
    targets = torch.arange(n, device=rows.device, dtype=torch.int32)
    half = n // 2
    out = {}
    for name in ("full", "sharded"):
        a, b = rows.clone().requires_grad_(), cols.clone().requires_grad_()
        if name == "full":
            lse, pos, rank = N.nce_lse_rank(a, b, targets)
        else:
            pos = (a * b[targets.long()]).sum(-1)
            parts = []
            for s in range(2):
                local = targets - s * half
                owned = (local >= 0) & (local < half)
                parts.append(N.nce_lse_rank_shard(
                    a, b[s * half:(s + 1) * half], pos,
                    torch.where(owned, local, -1).int()))
            lse = torch.logsumexp(torch.stack([p[0] for p in parts]), 0)
            rank = parts[0][1] + parts[1][1]
        loss = (lse - pos).mean()
        loss.backward()
        out[name] = dict(loss=loss.detach(), rank=rank, drows=a.grad,
                         dcols=b.grad)
    f, s = out["full"], out["sharded"]
    errs = {k: rel_err(s[k], f[k]) for k in ("loss", "drows", "dcols")}
    topk = {k: abs(float((s["rank"] < k).float().mean()
                         - (f["rank"] < k).float().mean())) for k in (1, 3, 5)}
    log(f"[ranks] two K7 shards combined against K5/K6 at {n}x{n}: rel err "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; top-k gaps {topk}")
    expect(errs["loss"] <= TOL_VALUE, f"the K7 combine's loss: {errs}")
    expect(errs["drows"] <= TOL_GRAD and errs["dcols"] <= TOL_GRAD,
           f"the K7 combine's gradients: {errs}")
    expect(max(topk.values()) <= RANK_ROWS, f"the K7 combine's top-k {topk}")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_steps(mesh, dev, steps: int, batch: int, run) -> dict:
    """``run(i)`` (step i of this rank, returning its metrics): 2 warm-up
    steps and ``steps`` timed ones (one, untimed, for 0) with the launch
    counts set to 0 just before them and read just after."""
    from dpc_tpu_torch.ops import _build

    warm = 2 if steps else 0
    for i in range(warm):
        run(i)
    _sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    metrics = [run(warm + i) for i in range(max(steps, 1))]
    _sync(dev)
    dt = time.perf_counter() - t0
    return {"losses": [float(m["loss"]) for m in metrics],
            "metrics": {k: float(v) for k, v in metrics[0].items()},
            "launches": dict(_build.LAUNCHES),
            "clips_per_s": max(steps, 1) * batch / dt}


def _rank_layout(mesh, cfg, fields, batch, steps, device="cuda", save=None):
    """One pretrain layout on this rank: a model from seed 0, the step, and
    ``_timed_steps``."""
    import torch
    from dpc_tpu_torch.core.config import TrainConfig
    from dpc_tpu_torch.models import dpc
    from dpc_tpu_torch.parallel import mesh as meshlib
    from dpc_tpu_torch.parallel.dryrun import param_digest
    from dpc_tpu_torch.train import optim, pretrain_step

    dev = torch.device(device)
    tcfg = TrainConfig(batch_size=batch, lr=1e-3, wd=1e-5, nce_impl="fused",
                       model_parallel=mesh.n_model, **fields)
    model = dpc.build_dpc(cfg, dev, seed=0)
    opt = optim.pretrain_optimizer(model, tcfg.lr, tcfg.wd)
    step = pretrain_step.make_pretrain_step(cfg, tcfg, model, opt, mesh)
    x = torch.randn(batch, cfg.num_seq, cfg.seq_len, cfg.img_dim,
                    cfg.img_dim, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    x = meshlib.shard_batch(mesh, x)
    gen = torch.Generator(device=dev)
    out = _timed_steps(mesh, dev, steps, batch, lambda i: step(
        x, gen.manual_seed(meshlib.dropout_seed(mesh, i))))
    out["digest"] = param_digest(model)
    if save and mesh.rank == 0:
        torch.save({k: v.float().cpu() for k, v in model.state_dict().items()},
                   save)
    return out


def _lc_rank_layout(mesh, cfg, ecfg, steps, device="cuda", save=None):
    """One LC finetune layout on this rank: the LC from seed 0, the step on
    this rank's clips of ``ecfg.batch_size``, and ``_timed_steps``; the
    digest covers the running statistics too."""
    import torch
    from dpc_tpu_torch.models import lc
    from dpc_tpu_torch.parallel import mesh as meshlib
    from dpc_tpu_torch.parallel.dryrun import param_digest
    from dpc_tpu_torch.train import finetune_step, optim

    dev = torch.device(device)
    model = lc.build_lc(cfg, ecfg.num_classes, dev, dropout=ecfg.dropout,
                        seed=0)
    opt = optim.finetune_optimizer(model, ecfg.lr, ecfg.wd, ecfg.train_what,
                                   ecfg.backbone_lr_scale)
    step = finetune_step.make_finetune_step(cfg, ecfg, model, opt, mesh)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(ecfg.batch_size, cfg.num_seq, cfg.seq_len, cfg.img_dim,
                    cfg.img_dim, 3, device=dev, generator=g)
    y = torch.randint(0, ecfg.num_classes, (ecfg.batch_size,), device=dev,
                      generator=g)
    x, y = meshlib.shard_batch(mesh, x), meshlib.shard_batch(mesh, y)
    gen = torch.Generator(device=dev)
    out = _timed_steps(mesh, dev, steps, ecfg.batch_size, lambda i: step(
        x, y, gen.manual_seed(meshlib.dropout_seed(mesh, i))))
    out["digest"] = param_digest(model)
    if save and mesh.rank == 0:
        torch.save({k: v.float().cpu() for k, v in model.state_dict().items()
                    if "num_batches" not in k}, save)
    return out


# the flagship's config, and the small f32 one of the {d,m} ≡ {d} check
RANK_FULL = dict(compute_dtype="bfloat16", gru_impl="pallas")
RANK_SMALL = dict(img_dim=64, num_seq=4, seq_len=5, pred_step=2,
                  gru_impl="pallas", gru_dropout=0.0)
# the LC flagship on two ranks (16 clips a rank), and its small f32 check
LC_RANK_LAYOUTS = (("lc_data2", 1), ("lc_data1_model2", 2))
LC_FULL = dict(compute_dtype="bfloat16", gru_impl="pallas", gru_dropout=0.1)
LC_FULL_EVAL = dict(num_classes=101, dropout=0.5, train_what="ft",
                    backbone_lr_scale=0.1, batch_size=32)
LC_SMALL = dict(img_dim=64, num_seq=4, seq_len=5, gru_impl="pallas",
                gru_dropout=0.0)
LC_SMALL_EVAL = dict(num_classes=11, dropout=0.0, batch_size=8)
# the dense test on 2 ranks and on 1 (the LC flagship in f32, 4 synthetic
# videos of 10 windows, 16 window rows a forward on every rank)
DENSE_ARGS = ["--dataset", "synthetic", "--synthetic_videos", "4",
              "--num_class", "101", "--compute_dtype", "float32",
              "--test", "random"]
# the dense test across cards: a test split of hundreds of videos in bf16
NCCL_DENSE_VIDEOS = 256
NCCL_DENSE_ARGS = ["--dataset", "synthetic", "--synthetic_videos",
                   str(NCCL_DENSE_VIDEOS), "--num_class", "101", "--test",
                   "random"]


def _ranks_body(rank: int, tmp: str, device: str, full: dict,
                batch: int, lc_full: dict, dense_args: list) -> dict:
    """Both ranks of phase 8 on the one card (gloo on CUDA tensors): the
    four pretrain layouts at ``full`` width and ``batch`` clips and the
    two LC layouts at ``lc_full`` width, each also in f32 at the small
    size; then the dense test on both ranks and on rank 0 alone."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, EvalConfig
    from dpc_tpu_torch.parallel import mesh as meshlib

    meshlib.rank_device(device, rank, same_card=True)
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, mp, fields in RANK_LAYOUTS:
        mesh = meshlib.make_mesh(0, model_parallel=mp)
        out[name] = _rank_layout(mesh, DPCConfig(**full), fields, batch,
                                 RANK_STEPS, device)
        out["small_" + name] = _rank_layout(
            mesh, DPCConfig(**RANK_SMALL), fields, 8, 0, device,
            save=os.path.join(tmp, f"{name}.pt") if mp == 2 else None)
    for name, mp in LC_RANK_LAYOUTS:
        mesh = meshlib.make_mesh(0, model_parallel=mp)
        out[name] = _lc_rank_layout(mesh, DPCConfig(**lc_full),
                                    EvalConfig(**LC_FULL_EVAL), RANK_STEPS,
                                    device)
        out["small_" + name] = _lc_rank_layout(
            mesh, DPCConfig(**LC_SMALL), EvalConfig(**LC_SMALL_EVAL), 0,
            device, save=os.path.join(tmp, f"{name}.pt") if mp == 2 else None)
    out["dense"] = _rank_dense_test(meshlib.make_mesh(0), tmp, device,
                                    dense_args)
    out["stem_group"] = _rank_stem_group(meshlib.make_mesh(0), device)
    return out


def _rank_stem_group(mesh, device: str) -> dict:
    """The fused stem in f32 at a small size with its statistics over the
    ranks of ``mesh`` (the ``bn_group`` of cross_replica_bn), each rank
    holding its share of the batch, against the fused stem on the whole
    batch on this rank alone: the output rows, dx and, summed over the
    ranks, the gradients of the conv weight, γ and β; both BN modes with
    batch statistics (the running statistics' EMA too).  Returns the
    relative errors."""
    import torch
    from dpc_tpu_torch.models import layers as L
    from dpc_tpu_torch.parallel import collectives

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(7)
    conv = torch.nn.Conv3d(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                           bias=False).to(dev)
    with torch.no_grad():                    # the same on every rank
        conv.weight.normal_(0.0, 0.1, generator=g)
    x = torch.randn(8, 2, 32, 32, 3, device=dev, generator=g)
    ct = torch.randn(8, 64, 2, 8, 8, device=dev, generator=g)
    per = x.shape[0] // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    errs = {}
    for track in (False, True):
        got = {}
        for name, xs, cts, group in (
                ("full", x, ct, None),
                ("group", x[rows], ct[rows], mesh.world_group)):
            bn = L.batchnorm3d(64, track_running_stats=track).to(dev)
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5, generator=g)
                bn.weight[::3] *= -1
                bn.weight[1] = 0
                bn.bias.normal_(generator=g)
            if name == "group":
                bn.load_state_dict(got["full"]["bn0"])
            conv.zero_grad()
            xg = xs.detach().requires_grad_(True)
            got[name] = {"bn0": {k: v.clone()
                                 for k, v in bn.state_dict().items()}}
            y = L.fused_stem(conv, bn, xg.permute(0, 4, 1, 2, 3),
                             group=group)
            (y * cts).sum().backward()
            grads = [conv.weight.grad, bn.weight.grad, bn.bias.grad]
            if group is not None:
                collectives.mean_flat_(grads, group)
                grads = [t * mesh.size for t in grads]
            got[name].update(y=y.detach(), dx=xg.grad, grads=grads,
                             stats=[bn.running_mean, bn.running_var]
                             if track else [])
        full, grp = got["full"], got["group"]
        errs[f"track={track}"] = {
            "y": rel_err(grp["y"], full["y"][rows]),
            "dx": rel_err(grp["dx"], full["dx"][rows]),
            "grads": max(rel_err(a, b) for a, b in zip(grp["grads"],
                                                       full["grads"])),
            "stats": max([rel_err(a, b) for a, b in zip(grp["stats"],
                                                        full["stats"])],
                         default=0.0)}
    return errs


def _rank_dense_test(mesh, tmp: str, device: str, args: list,
                     rank_wb: int = 16) -> dict:
    """``evaluate.run_test`` of the LC from seed 0 on the ranks of ``mesh``
    (the videos split between them), then on rank 0 alone over the same
    videos, ``rank_wb`` window rows a forward on a rank each time: loss,
    top-1, top-5, the windows/s and the launches."""
    import torch
    from dpc_tpu_torch.models import lc
    from dpc_tpu_torch.ops import _build
    from dpc_tpu_torch.train import evaluate

    cfg = evaluate.config_from_args(evaluate.build_parser().parse_args(args))
    dev = torch.device(device)
    model = lc.build_lc(cfg.model, cfg.eval.num_classes, dev, seed=0)
    out = {}
    for n, m in ((mesh.size, mesh), (1, None)):
        if m is None and mesh.rank:
            break
        exp_dir = os.path.join(tmp, f"dense{n}")
        _build.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loss, top1 = evaluate.run_test(cfg, model, exp_dir,
                                           window_batch=rank_wb * n, mesh=m)
        rate = re.search(r"windows / \d+ videos in \S+ = (\S+) windows/s",
                         buf.getvalue())
        out[n] = {"loss": loss, "top1": top1, "launches":
                  dict(_build.LAUNCHES),
                  "windows_per_s": float(rate.group(1)) if rate else None}
        if mesh.rank == 0:
            log_md = Path(exp_dir, "test_log.md").read_text()
            out[n]["top5"] = float(log_md.split("top5: ")[-1].split()[0])
    return out


def _one_rank_small(path: str, device: str) -> dict:
    """The f32 small step on one device, global negatives (the same pool
    as one data group of {data:1, model:2}), its parameters to ``path``."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig
    from dpc_tpu_torch.parallel import mesh as meshlib

    torch.backends.cudnn.allow_tf32 = False
    try:
        return _rank_layout(meshlib.make_mesh(), DPCConfig(**RANK_SMALL),
                            dict(negatives="global"), 8, 0, device,
                            save=path)
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _compare_small(one: dict, two: dict, p1: dict, p2: dict) -> None:
    """{data:1, model:2} against one rank: loss and top-k within 1e-4;
    the updated parameters as the CPU tests hold them (every one within
    the 2·lr of a flipped Adam sign, the updates' cosine at least 0.99,
    99.5% within 1e-4 of the largest parameter)."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig
    from dpc_tpu_torch.models import dpc

    for k, v in one["metrics"].items():
        gap = abs(two["metrics"][k] - v) / max(abs(v), 1e-30)
        expect(gap <= 1e-4, f"{{d,m}} != {{d}} on the card: {k} "
                            f"{two['metrics'][k]} vs {v}")
    before = {k: v.float() for k, v in dpc.build_dpc(
        DPCConfig(**RANK_SMALL), torch.device("cpu"),
        seed=0).state_dict().items()}
    scale = max(float(v.abs().max()) for v in p1.values())
    close = total = 0
    dot = n1 = n2 = 0.0
    for k in p1:
        u1, u2 = (p1[k] - before[k]).double(), (p2[k] - before[k]).double()
        diff = (u1 - u2).abs()
        expect(float(diff.max()) <= 2.05e-3, f"{{d,m}} != {{d}}: {k}")
        close += int((diff <= 1e-4 * scale).sum())
        total += diff.numel()
        dot += float((u1 * u2).sum())
        n1 += float((u1 * u1).sum())
        n2 += float((u2 * u2).sum())
    cos = dot / math.sqrt(n1 * n2)
    log(f"[ranks] {{data:1, model:2}} f32 against one rank: loss "
        f"{two['metrics']['loss']} vs {one['metrics']['loss']}, top1 "
        f"{two['metrics']['top1']} vs {one['metrics']['top1']}; updates' "
        f"cosine {cos:.6f}, {100 * close / total:.3f}% of the parameters "
        "within 1e-4 of the largest")
    expect(cos >= 0.99 and close >= 0.995 * total,
           f"{{d,m}} != {{d}}: cosine {cos}, {close}/{total} close")


def _one_rank_lc_small(path: str, device: str) -> dict:
    """The f32 small LC step on one device, its state to ``path``."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, EvalConfig
    from dpc_tpu_torch.parallel import mesh as meshlib

    torch.backends.cudnn.allow_tf32 = False
    try:
        return _lc_rank_layout(meshlib.make_mesh(), DPCConfig(**LC_SMALL),
                               EvalConfig(**LC_SMALL_EVAL), 0, device,
                               save=path)
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _compare_lc_small(one: dict, two: dict, p1: dict, p2: dict) -> None:
    """The LC step on {data:1, model:2} against one rank, f32, dropout off:
    loss within 1e-5 relative, top-k equal, the Adam updates' cosine at
    least 0.999 and the running statistics within 1e-4 of each tensor's
    largest (BN over the model group is the one rank's BN)."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig
    from dpc_tpu_torch.models import lc

    m1, m2 = one["metrics"], two["metrics"]
    gap = abs(m2["loss"] - m1["loss"]) / abs(m1["loss"])
    before = lc.build_lc(DPCConfig(**LC_SMALL), LC_SMALL_EVAL["num_classes"],
                         torch.device("cpu"), seed=0).state_dict()
    dot = n1 = n2 = 0.0
    stats = 0.0
    for k, v in p1.items():
        if "running" in k:
            stats = max(stats, rel_err(p2[k], v))
            continue
        u1, u2 = (v - before[k]).double(), (p2[k] - before[k]).double()
        dot += float((u1 * u2).sum())
        n1 += float((u1 * u1).sum())
        n2 += float((u2 * u2).sum())
    cos = dot / math.sqrt(n1 * n2)
    log(f"[ranks] LC {{data:1, model:2}} f32 against one rank: loss "
        f"{m2['loss']} vs {m1['loss']} (rel {gap:.2e}), top1 {m2['top1']} "
        f"vs {m1['top1']}; updates' cosine {cos:.6f}; running stats rel "
        f"err {stats:.2e}")
    expect(gap <= 1e-5, f"LC {{d,m}} != {{d}}: loss gap {gap}")
    expect(m1["top1"] == m2["top1"] and m1["top5"] == m2["top5"],
           f"LC {{d,m}} != {{d}}: top-k {m2} vs {m1}")
    expect(cos >= 0.999, f"LC {{d,m}} != {{d}}: updates' cosine {cos}")
    expect(stats <= 1e-4, f"LC {{d,m}} != {{d}}: running stats {stats}")


def _check_dense_ranks(res: list, n: int, tol: float, what: str,
                       on_card: bool) -> tuple:
    """The dense test on ``n`` ranks against 1 rank on the same videos:
    loss within ``tol`` relative, top-1 and top-5 equal, every rank
    returning the same sums; K1 and K3 launched on every rank.  Returns
    the windows/s on ``n`` ranks and on one."""
    many, one = res[0][n], res[0][1]
    expect(all(r[n]["loss"] == many["loss"] and r[n]["top1"] == many["top1"]
               for r in res), "the ranks' dense-test results differ")
    gap = abs(many["loss"] - one["loss"]) / abs(one["loss"])
    log(f"{what} on {n} ranks / 1 rank: loss {many['loss']} / "
        f"{one['loss']} (rel {gap:.2e}), top1 {many['top1']} / "
        f"{one['top1']}, top5 {many['top5']} / {one['top5']}; "
        f"{many['windows_per_s']} / {one['windows_per_s']} windows/s; "
        f"launches {[r[n]['launches'] for r in res]}")
    expect(gap <= tol and many["top1"] == one["top1"]
           and many["top5"] == one["top5"],
           f"the {n}-rank dense test differs from 1 rank: {many} vs {one}")
    kernels = EVAL_KERNELS
    expect(not on_card or all(r[n]["launches"][k] > 0 for r in res
                              for k in kernels),
           "K1 or K3 did not launch in a rank's dense test")
    return many["windows_per_s"], one["windows_per_s"]


def _ranks_finetune_cli() -> dict:
    """The finetune CLI's refusal of two ranks on one card, and the CLI
    with ``--num_devices 2 --device cpu`` (two gloo ranks on the host):
    one epoch of 2 steps with val and a checkpoint (the dense test across
    ranks runs in ``_rank_dense_test``)."""
    from dpc_tpu_torch.train import evaluate

    try:
        with contextlib.redirect_stdout(io.StringIO()):
            evaluate.main(["--dataset", "synthetic", "--num_devices", "2"])
    except SystemExit as e:
        msg = str(e.code)
    else:
        msg = ""
    log(f"[ranks] finetune --num_devices 2 on one card: {msg!r}")
    expect("needs 2 cards" in msg, "the finetune CLI put two ranks on one "
                                   "card")
    small = ["--device", "cpu", "--num_devices", "2", "--dataset",
             "synthetic", "--img_dim", "32", "--num_seq", "3", "--seq_len",
             "4", "--compute_dtype", "float32", "--batch_size", "4",
             "--synthetic_videos", "8", "--num_workers", "2",
             "--print_freq", "1", "--epochs", "1", "--steps_per_epoch", "2"]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "dpc_tpu_torch.train.evaluate", *small,
             "--log_dir", tmp], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
    for line in proc.stdout.splitlines():
        log(f"[ranks finetune cli] {line}")
    expect(proc.returncode == 0, f"the 2-rank CPU finetune CLI failed: "
                                 f"{proc.stderr[-3000:]}")
    expect("[epoch 0] 2 train steps" in proc.stdout
           and "val loss" in proc.stdout
           and "devices: {'data': 2, 'model': 1}" in proc.stdout,
           "the 2-rank CPU finetune CLI did not train and validate")
    return {"finetune_refusal": msg}


def _ranks_cli() -> dict:
    """The pretrain CLI on the card with one rank and the multi-rank
    flags, and its refusal of two ranks on one card."""
    from dpc_tpu_torch.train import pretrain

    out = _run_cli(pretrain.main,
                   ["--dataset", "synthetic", "--nce_impl", "fused",
                    "--batch_size", "8", "--epochs", "1",
                    "--steps_per_epoch", "2", "--num_workers", "4",
                    "--print_freq", "1", "--num_devices", "1",
                    "--negatives", "global", "--cross_replica_bn"],
                   "ranks cli", PRETRAIN_KERNELS)
    expect("[epoch 0] 2 train steps" in out, "the 1-rank CLI did not run")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            pretrain.main(["--dataset", "synthetic", "--num_devices", "2",
                           "--negatives", "global"])
    except SystemExit as e:
        msg = str(e.code)
    else:
        msg = ""
    log(f"[ranks] --num_devices 2 on one card: {msg!r}")
    expect("needs 2 cards" in msg, "two ranks on one card were not refused")
    return {"refusal": msg}


def phase_ranks(device: str = "cuda", full: dict = RANK_FULL,
                batch: int = 64, nce_shape: int = 3072,
                lc_full: dict = LC_FULL, dense_args: list = DENSE_ARGS
                ) -> dict:
    """K7 against its plain version and the two-shard combine against
    K5/K6; then on two ranks sharing the one card, over gloo (NCCL refuses
    two ranks on one device): the pretrain step in four full-width layouts
    and the LC finetune step in two, each also at a small f32 size with
    {data:1, model:2} held against one rank, and the dense test on 2 ranks
    against 1; then the pretrain CLI's multi-rank flags on one rank, both
    CLIs' refusal of two ranks on one card, and the finetune CLI on two
    CPU ranks."""
    import torch
    from dpc_tpu_torch.parallel import mesh as meshlib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, half = nce_shape, nce_shape // 2
    timed = device == "cuda"
    try:
        k7 = check_nce_shard(n, half, 256, timed, device)  # {data:1, model:2}
        check_nce_shard(half, half, 256, False, device)    # {data:2, model:2}
        check_shard_combine(n, 256, device)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
           if device == "cuda" else "the CPU")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        t0 = time.perf_counter()
        ranks = meshlib.run_ranks(_ranks_body, 2, (tmp, device, full, batch,
                                                   lc_full, dense_args),
                                  backend="gloo")
        took = time.perf_counter() - t0
        one = _one_rank_small(os.path.join(tmp, "one.pt"), device)
        load = lambda n: torch.load(os.path.join(tmp, f"{n}.pt"),
                                    weights_only=True)
        _compare_small(one, ranks[0]["small_data1_model2"], load("one"),
                       load("data1_model2"))
        one_lc = _one_rank_lc_small(os.path.join(tmp, "one_lc.pt"), device)
        _compare_lc_small(one_lc, ranks[0]["small_lc_data1_model2"],
                          load("one_lc"), load("lc_data1_model2"))
    rates = {}
    for name, mp, _ in RANK_LAYOUTS:
        for kind in (name, "small_" + name):
            res = [r[kind] for r in ranks]
            expect(all(math.isfinite(v) for r in res for v in r["losses"]),
                   f"{kind}: non-finite loss {[r['losses'] for r in res]}")
            expect(len({r["digest"] for r in res}) == 1,
                   f"{kind}: the ranks' parameters differ after the steps")
        res = [r[name] for r in ranks]
        # CPU tensors take the plain versions: no launches to count there
        kernels = ((SHARD_KERNELS if mp == 2 else PRETRAIN_KERNELS)
                   if timed else ())
        for i, r in enumerate(res):
            expect(all(r["launches"][k] == RANK_STEPS for k in kernels),
                   f"{name} rank {i}: a kernel did not launch once a step: "
                   f"{r['launches']}")
        rates[name] = res[0]["clips_per_s"]
        log(f"[ranks] {name} (R18-128 B64 bf16, {{data:{2 // mp}, model:"
            f"{mp}}}): losses {res[0]['losses']}; {rates[name]:.2f} clips/s "
            f"on {smi}, two ranks sharing one card over gloo (not a "
            f"multi-GPU rate); rank launches {[r['launches'] for r in res]}")
    lc_launches = {}
    for name, mp in LC_RANK_LAYOUTS:
        for kind in (name, "small_" + name):
            res = [r[kind] for r in ranks]
            expect(all(math.isfinite(v) for r in res for v in r["losses"]),
                   f"{kind}: non-finite loss {[r['losses'] for r in res]}")
            expect(len({r["digest"] for r in res}) == 1,
                   f"{kind}: the ranks' parameters or running statistics "
                   "differ after the steps")
        res = [r[name] for r in ranks]
        for i, r in enumerate(res):
            expect(all(r["launches"][k] == RANK_STEPS
                       for k in (LC_KERNELS if timed else ())),
                   f"{name} rank {i}: a kernel did not launch once a step: "
                   f"{r['launches']}")
        rates[name] = res[0]["clips_per_s"]
        lc_launches[name] = res[0]["launches"]
        log(f"[ranks] {name} (LC R18-128 8x5 B32 bf16, {{data:{2 // mp}, "
            f"model:{mp}}}): losses {res[0]['losses']}; {rates[name]:.2f} "
            f"clips/s on {smi}, two ranks sharing one card over gloo (not a "
            f"multi-GPU rate); rank launches {[r['launches'] for r in res]}")
    two, one = _check_dense_ranks(
        [r["dense"] for r in ranks], 2, 1e-4,
        f"[ranks] dense test (LC R18-128 8x5 f32, 4 synthetic videos) on "
        f"{smi}, two ranks sharing one card,", timed)
    dense = {"two": two, "one": one}
    for i, r in enumerate(ranks):
        log(f"[ranks] fused stem over the group (f32, 8 clips) against the "
            f"whole batch on one rank, rank {i}: rel errors "
            f"{r['stem_group']}")
        for mode, e in r["stem_group"].items():
            expect(e["y"] <= TOL_VALUE and e["stats"] <= TOL_VALUE
                   and max(e["dx"], e["grads"]) <= TOL_GRAD,
                   f"the fused stem over the group differs from the whole "
                   f"batch ({mode}, rank {i}): {e}")
    log(f"[ranks] the two ranks' run took {took:.1f} s")
    cli = _ranks_cli() if device == "cuda" else {}
    ft_cli = _ranks_finetune_cli() if device == "cuda" else {}
    return {"k7": k7, "rates": rates, "smi": smi, **cli, **ft_cli,
            "dense_windows_per_s": dense, "lc_launches": lc_launches,
            "launches": ranks[0]["data1_model2"]["launches"]}


def _nccl_body(rank: int, n_model: int, tmp: str) -> dict:
    """One rank a card over NCCL: the full-width pretrain step in the
    layouts of phase 8 with the data axis over every card, the LC step at
    global batch 32 on every card and with a model axis, and
    ``evaluate.run_test`` of the LC flagship on every card against one."""
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, EvalConfig
    from dpc_tpu_torch.parallel import mesh as meshlib

    dev = meshlib.rank_device("cuda", rank)
    out = {}
    for name, mp, fields in (("data_local", 1, dict(negatives="local")),
                             ("data_global", 1, dict(negatives="global")),
                             ("data_xbn", 1, dict(negatives="local",
                                                  cross_replica_bn=True)),
                             ("data_model2", n_model,
                              dict(negatives="global"))):
        mesh = meshlib.make_mesh(0, model_parallel=mp)
        out[name] = dict(_rank_layout(mesh, DPCConfig(**RANK_FULL), fields,
                                      64, RANK_STEPS), shape=mesh.shape)
    for name, mp in (("lc_data", 1), ("lc_data_model2", n_model)):
        mesh = meshlib.make_mesh(0, model_parallel=mp)
        out[name] = dict(_lc_rank_layout(mesh, DPCConfig(**LC_FULL),
                                         EvalConfig(**LC_FULL_EVAL),
                                         RANK_STEPS), shape=mesh.shape)
    out["dense"] = _rank_dense_test(meshlib.make_mesh(0), tmp, str(dev),
                                    NCCL_DENSE_ARGS, rank_wb=32)
    torch.cuda.synchronize(dev)
    return out


def _nccl_finetune_cli(n: int, tmp: str) -> None:
    """The finetune CLI on ``n`` cards with a model axis of 2: 4 steps and
    validation, then ``--test`` of the run on every card."""
    common = ["--dataset", "synthetic", "--num_devices", str(n),
              "--model_parallel", "2", "--num_workers", "4",
              "--print_freq", "1"]
    for what, extra in (
            ("train", ["--batch_size", "32", "--epochs", "1",
                       "--steps_per_epoch", "4", "--synthetic_videos",
                       str(32 * n), "--log_dir", tmp]),
            ("test", ["--test", None, "--synthetic_videos", "8",
                      "--log_dir", os.path.join(tmp, "test")])):
        if None in extra:
            extra[1] = str(next(Path(tmp).glob("*/model")).parent)
        proc = subprocess.run(
            [sys.executable, "-m", "dpc_tpu_torch.train.evaluate", *common,
             *extra], cwd=ROOT, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            log(f"[nccl finetune cli] {line}")
        ok = ("[epoch 0] 4 train steps" in proc.stdout if what == "train"
              else f"over {n} ranks" in proc.stdout)
        expect(proc.returncode == 0 and ok,
               f"the multi-card finetune CLI's {what} did not run: "
               f"{proc.stderr[-3000:]}")


def nccl_ranks(n: int) -> dict:
    """The steps and both CLIs on ``n`` cards of one host over NCCL, one
    rank a card: the pretrain step (R18-128 B64 bf16, fused NCE) in four
    layouts, the LC step (R18-128 8x5 B32 bf16) on the data axis and with
    a model axis, finite losses, bit-identical parameters, the kernels
    launched on every rank, and clips/s of each layout; the dense test
    (``evaluate.run_test``) on every card against one: the same results
    and its windows/s."""
    from dpc_tpu_torch.ops import _build
    from dpc_tpu_torch.parallel import mesh as meshlib

    _build.build()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        ranks = meshlib.run_ranks(_nccl_body, n, (2, tmp), backend="nccl")
    rates = {}
    for name in ranks[0]:
        if name == "dense":
            continue
        res = [r[name] for r in ranks]
        kernels = (SHARD_KERNELS if name == "data_model2" else
                   LC_KERNELS if name.startswith("lc_")
                   else PRETRAIN_KERNELS)
        expect(all(math.isfinite(v) for r in res for v in r["losses"]),
               f"{name}: non-finite loss")
        expect(len({r["digest"] for r in res}) == 1,
               f"{name}: the ranks' parameters differ")
        expect(all(r["launches"][k] == RANK_STEPS for r in res
                   for k in kernels), f"{name}: a kernel did not launch")
        rates[name] = res[0]["clips_per_s"]
        log(f"[nccl] {name} {res[0]['shape']}: losses {res[0]['losses']}; "
            f"{rates[name]:.2f} clips/s; launches {res[0]['launches']}")
    many, one = _check_dense_ranks(
        [r["dense"] for r in ranks], n, 1e-3,
        f"[nccl] dense test (evaluate.run_test, LC R18-128 8x5 bf16, "
        f"{NCCL_DENSE_VIDEOS} synthetic videos rendered on each rank's "
        f"host thread, 32 window rows a forward a card)", True)
    dense = {"all": many, "one": one}
    # the CLIs start their ranks themselves, which print to their own stdout
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "dpc_tpu_torch.train.pretrain",
             "--dataset", "synthetic", "--nce_impl", "fused", "--batch_size",
             "64", "--epochs", "1", "--synthetic_videos", str(64 * n),
             "--steps_per_epoch", "4", "--num_workers", "4", "--print_freq",
             "1", "--num_devices", str(n), "--model_parallel", "2",
             "--negatives", "global", "--log_dir", tmp],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            log(f"[nccl cli] {line}")
        expect(proc.returncode == 0
               and "[epoch 0] 4 train steps" in proc.stdout,
               f"the multi-card CLI did not run: {proc.stderr[-3000:]}")
        _nccl_finetune_cli(n, os.path.join(tmp, "finetune"))
    return {**rates, "dense_windows_per_s": dense}


# ---------------------------------------------------------------------------

def kernels_line(k: dict, launches: dict) -> dict:
    """The per-kernel JSON record: K3-K4 and the pool kernels at the LC
    flagship shapes, K5-K6 at the pretrain shapes.  ``launches`` is each
    kernel's count in the run of its path with the counts set to 0 just
    before it: the pretrain flagship's main path (stem_impl "auto") for
    K1, its ReLU-off instance and K5-K6, the LC main path for K2-K4, the
    eqroute pretrain step for K8, the model axis's for K7.  K1 is off the
    main path on the card ("auto" is the fused stem): its row adds its
    count over the 5 steps of the unfused stem (``_stem_turns``) as
    ``launches_unfused_stem``."""
    def row(name, src, replaces, t, err, n, **extra):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"], **extra}

    g, n, p, k7 = k["gru_lc"], k["nce"], k["pool"], k["k7"]
    lc_n, pre_n, mp_n, eq_n = (launches["lc"], launches["pretrain"],
                               launches["model_axis"], launches["eqroute"])
    unfused_n = launches["stem_unfused"]
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
            p["fwd"]["err"], pre_n["maxpool_relu_fwd"],
            launches_unfused_stem=unfused_n["maxpool_relu_fwd"]),
        row("maxpool_fwd", pool_src, f"{pool_tpu}:163", p["fwd_raw"],
            p["fwd_raw"]["err"], pre_n["maxpool_fwd"]),
        row("maxpool_relu_bwd", pool_src, f"{pool_tpu}:208", p["bwd"],
            p["bwd"]["err"], lc_n["maxpool_relu_bwd"]),
        row("maxpool_bwd_eq", pool_src, f"{pool_tpu}:303", p["eq"],
            p["eq"]["err"], eq_n["maxpool_bwd_eq"]),
        row("nce_fwd_shard", nce_src, "dpc_tpu/ops/nce_pallas.py:351",
            k7["fwd"], k7["fwd_err"], mp_n["nce_fwd_shard"]),
        row("nce_bwd_shard", nce_src, "dpc_tpu/ops/nce_pallas.py:380",
            k7["bwd"], k7["bwd_err"], mp_n["nce_bwd_shard"]),
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
    ap.add_argument("--nccl", metavar="N", type=int, default=0,
                    help="only run the pretrain and LC steps, the dense "
                         "test's forward and both CLIs on N cards over "
                         "NCCL, one rank a card, and print their rates "
                         "(no ok line)")
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
    if args.nccl:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        try:
            rates = nccl_ranks(args.nccl)
        except Failed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(smi)
        print(json.dumps({"nccl_rates": rates, "cards": args.nccl}))
        return 0
    if args.cli_rates:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip())
        cli_rates([pair.split("=", 1) for pair in args.cli_rates])
        return 0
    t0 = time.perf_counter()

    def timed(name, fn, *a):
        start = time.perf_counter()
        out = fn(*a)
        log(f"[time] phase {name}: {time.perf_counter() - start:.1f} s")
        return out

    profile = args.profile or None
    try:
        timed("build", phase_build)
        k = timed("kernels", phase_kernels, profile)
        s = timed("step", phase_step, profile)
        lc = timed("lc", phase_lc, profile)
        timed("cli", phase_cli)
        frames = timed("frames", phase_frames)
        tools = timed("tools", phase_tools, s["ms_per_step"])
        ranks = timed("ranks", phase_ranks)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"[frames] rates on {smi.stdout.strip()}: {json.dumps(frames)}")
    log(f"[tools] on {smi.stdout.strip()}: {json.dumps(tools)}")
    log(f"[lc] dense-test windows/s on {smi.stdout.strip()}: "
        f"{lc['dense_test_windows_per_s']}")
    log(f"[ranks] clips/s of two ranks sharing one card over gloo on "
        f"{smi.stdout.strip()}: {json.dumps(ranks['rates'])}; dense-test "
        f"windows/s on 2 ranks / 1 rank: "
        f"{json.dumps(ranks['dense_windows_per_s'])}")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line(
        {**k, "k7": ranks["k7"]},
        {"pretrain": s["launches"], "lc": lc["launches"],
         "model_axis": ranks["launches"], "eqroute": s["eq_launches"],
         "stem_unfused": s["stem_launches"]["unfused"]})))
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
