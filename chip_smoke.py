"""Smoke run of dpc_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, and drives the DPC pretrain
step at its full width.

    python3 chip_smoke.py [--profile PATH]

Phases, each printing its facts before the next starts:
  1. build    compile csrc/*.cu for sm_90a (one nvcc per source, in parallel)
  2. kernels  K-GRU-F/B and K-NCE-F/B against their plain versions on the
              card, at the flagship shapes, the 6144-row NCE shape and ragged
              shapes, with f32 matmul and cuDNN TF32 off; values and grads
  3. step     a small f32 step through the kernels against the same step
              through the plain paths; then the flagship R18-128, B=64, bf16
              train step through make_pretrain_step with gru_impl="pallas"
              and nce_impl="fused": 2 warm-up and 10 timed steps, with the
              kernels' launch counts read around the timed steps
  4. cli      python -m dpc_tpu_torch.train.pretrain for 2 synthetic steps
Then one JSON line of per-kernel results, the card's name and power limit,
and a last line {"ok": true, "device": {...}}.  Any failure exits non-zero
before the last line.  Without a CUDA device it exits 2 and prints no result.

--profile PATH writes a torch.profiler table of two flagship steps to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM rate and dense f32 rate on the CUDA cores
# (the kernels compute in f32 without tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

TOL_VALUE = 1e-5   # max |kernel − plain| / max |plain|, forward values
TOL_GRAD = 1e-4    # the same for gradients (longer f32 reductions)
RANK_ROWS = 0.01   # share of rows whose rank may differ, by at most 2: a
                   # score within f32 rounding of pos flips a strict >


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Failed(Exception):
    pass


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from dpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    took = _build.build()
    log(f"[build] {', '.join(f'{k}.cu {v:.1f} s' for k, v in took.items())}"
        f"; total {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in _build.SOURCES:
        _build.library(name)


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


def check_gru(t, r, d, timed: bool) -> dict:
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
        wbytes = sum(p.numel() for p in w) * 4
        fwd_ops = 2 * t * r * 3 * d * (2 * d)
        res["fwd"] = dict(
            ms=cuda_ms(lambda: G.convgru_forward(x, h0, w, m)),
            plain_ms=cuda_ms(lambda: G.convgru_forward_plain(x, h0, w, m)),
            library_ms=cuda_ms(lambda: _gru_library_fwd(x, h0, w, m)),
            bound=bound_ms(4 * (3 * t * r * d + r * d) + wbytes, fwd_ops))
        res["bwd"] = dict(
            ms=cuda_ms(lambda: G.convgru_backward(x, h0, out_k, w, m, gout)),
            plain_ms=cuda_ms(lambda: G.convgru_backward_plain(
                x, h0, out_p, w, m, gout)),
            library_ms=None,
            bound=bound_ms(4 * (5 * t * r * d + 2 * r * d) + 2 * wbytes,
                           3 * fwd_ops))
        log(f"[kernels] GRU T={t} R={r} D={d}: fwd {res['fwd']['ms']:.3f} ms "
            f"(plain {res['fwd']['plain_ms']:.3f}, cuBLAS loop "
            f"{res['fwd']['library_ms']:.3f}, bound "
            f"{res['fwd']['bound'][0]:.3f}); bwd {res['bwd']['ms']:.3f} ms "
            f"(plain {res['bwd']['plain_ms']:.3f}, bound "
            f"{res['bwd']['bound'][0]:.3f})")
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

        res["fwd"] = dict(
            ms=cuda_ms(lambda: N.nce_forward(rows, cols, pos, targets)),
            plain_ms=cuda_ms(lambda: N.nce_forward_plain(rows, cols, pos,
                                                         targets)),
            library_ms=cuda_ms(library),
            bound=bound_ms(4 * ((r + c) * d + 4 * r), 2 * r * c * d))
        res["bwd"] = dict(
            ms=cuda_ms(lambda: N.nce_backward(rows, cols, lse_p, gl)),
            plain_ms=cuda_ms(lambda: N.nce_backward_plain(rows, cols, lse_p,
                                                          gl)),
            library_ms=None,
            bound=bound_ms(4 * (2 * (r + c) * d + 2 * r), 6 * r * c * d))
        log(f"[kernels] NCE R={r} C={c} D={d}: fwd {res['fwd']['ms']:.3f} ms "
            f"(plain {res['fwd']['plain_ms']:.3f}, matmul+logsumexp "
            f"{res['fwd']['library_ms']:.3f}, bound "
            f"{res['fwd']['bound'][0]:.3f}); bwd {res['bwd']['ms']:.3f} ms "
            f"(plain {res['bwd']['plain_ms']:.3f}, bound "
            f"{res['bwd']['bound'][0]:.3f})")
    return res


def phase_kernels() -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        gru = check_gru(5, 1024, 256, timed=True)      # flagship
        gru_r = check_gru(5, 2156, 256, timed=False)   # ragged: 44 clips at 7²
        nce = check_nce(3072, 3072, 256, 0, timed=True)  # flagship
        nce_big = check_nce(6144, 6144, 256, 0, timed=True)  # batch 128
        nce_r = check_nce(1000, 1500, 256, 37, timed=False)  # ragged
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    return {"gru": gru, "gru_ragged": gru_r, "nce": nce, "nce_6144": nce_big,
            "nce_ragged": nce_r}


# ---------------------------------------------------------------------------
# 3. the train step
# ---------------------------------------------------------------------------

def _small_step_check() -> None:
    """One f32 step at a small size through the kernels and through the
    plain paths (scan GRU, materialised score), same weights and batch: the
    losses must agree."""
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
        for gru_impl, nce_impl in (("pallas", "fused"), ("scan", "xla")):
            cfg = DPCConfig(img_dim=64, num_seq=4, seq_len=5, pred_step=2,
                            gru_impl=gru_impl, gru_dropout=0.0)
            model = dpc.build_dpc(cfg, dev, seed=0)
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


def phase_step(profile: str | None) -> dict:
    import torch
    from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
    from dpc_tpu_torch.models import dpc
    from dpc_tpu_torch.ops import _build
    from dpc_tpu_torch.train import optim, pretrain_step

    _small_step_check()
    dev = torch.device("cuda")
    cfg = DPCConfig(compute_dtype="bfloat16", gru_impl="pallas")
    batch = 64
    tcfg = TrainConfig(batch_size=batch, lr=1e-3, wd=1e-5, nce_impl="fused")
    model = dpc.build_dpc(cfg, dev, seed=0)
    step = pretrain_step.make_pretrain_step(
        cfg, tcfg, model, optim.pretrain_optimizer(model, tcfg.lr, tcfg.wd))
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(batch, cfg.num_seq, cfg.seq_len, cfg.img_dim,
                    cfg.img_dim, 3, device=dev, generator=gen)
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
    launches = dict(_build.LAUNCHES)
    losses = [float(m["loss"]) for m in metrics]
    top1 = [float(m["top1"]) for m in metrics]
    log(f"[step] R18-128 B={batch} bf16 gru=pallas nce=fused: "
        f"{n_steps * batch / dt:.2f} clips/s ({1e3 * dt / n_steps:.1f} ms/step,"
        f" peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    log(f"[step] losses {losses}")
    log(f"[step] top1 {top1}")
    log(f"[step] launches over {n_steps} steps: {launches}")
    expect(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    expect(all(v > 0 for v in launches.values()),
           f"a kernel of the path did not run: {launches}")

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t1 = time.perf_counter()
            for _ in range(2):
                step(x, gen)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t1)
        events = p.key_averages()
        busy_ms = sum(e.self_device_time_total for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        summary = (f"2 steps: wall {wall_ms:.1f} ms, device busy "
                   f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
        table = events.table(sort_by="self_cuda_time_total", row_limit=80)
        Path(profile).parent.mkdir(parents=True, exist_ok=True)
        Path(profile).write_text(summary + "\n" + table)
        log(f"[step] profile: {summary}; table in {profile}")
    return {"launches": launches, "clips_per_s": n_steps * batch / dt}


# ---------------------------------------------------------------------------
# 4. the CLI
# ---------------------------------------------------------------------------

def phase_cli() -> None:
    from dpc_tpu_torch.ops import _build
    from dpc_tpu_torch.train import pretrain

    _build.reset_launches()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        with contextlib.redirect_stdout(buf):
            pretrain.main(["--dataset", "synthetic", "--nce_impl", "fused",
                           "--batch_size", "8", "--epochs", "1",
                           "--steps_per_epoch", "2", "--num_workers", "4",
                           "--print_freq", "1", "--log_dir", tmp])
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[cli] {line}")
    line = [ln for ln in out.splitlines() if ln.startswith("epoch 0: train")]
    expect(bool(line) and "(2 steps" in line[0], "CLI did not run 2 steps")
    loss = float(line[0].split("loss")[1].split()[0])
    expect(math.isfinite(loss), f"CLI loss {loss}")
    log(f"[cli] launches: {dict(_build.LAUNCHES)}")
    expect(all(v > 0 for v in _build.LAUNCHES.values()),
           "a kernel did not run in the CLI")


# ---------------------------------------------------------------------------

def kernels_line(k: dict, launches: dict) -> dict:
    def row(name, src, replaces, key, res):
        t = res[key]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": res[f"{key}_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["library_ms"]}

    g, n = k["gru"], k["nce"]
    return {"kernels": [
        row("convgru_fwd", "dpc_tpu_torch/csrc/convgru.cu",
            "dpc_tpu/ops/convgru_pallas.py:88", "fwd", g),
        row("convgru_bwd", "dpc_tpu_torch/csrc/convgru.cu",
            "dpc_tpu/ops/convgru_pallas.py:207", "bwd", g),
        row("nce_fwd", "dpc_tpu_torch/csrc/nce.cu",
            "dpc_tpu/ops/nce_pallas.py:97", "fwd", n),
        row("nce_bwd", "dpc_tpu_torch/csrc/nce.cu",
            "dpc_tpu/ops/nce_pallas.py:224", "bwd", n),
    ]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="")
    args = ap.parse_args(argv)
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
    t0 = time.perf_counter()
    try:
        phase_build()
        k = phase_kernels()
        s = phase_step(args.profile or None)
        phase_cli()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line(k, s["launches"])))
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
