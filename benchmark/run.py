"""Run one cell of the benchmark once and print its result.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic file; its job drives the system under test, ``dpc_tpu_torch``'s
train step in its own epoch loop, for ``--seconds`` after set-up and
warm-up, then checks the first steps against the plain reference under
``benchmark/reference``.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit; the same numbers end
standard error.  It needs as many CUDA cards as the cell asks for: without
them it prints no result and exits non-zero, as it does when ``jax``,
``jaxlib``, ``flax`` or ``dpc_tpu`` is loaded once the window has closed,
in this process or in any rank's.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return " | ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def result(cell, results: list, trace: bool, t_start: float) -> dict:
    """The result line's object from the ranks' returns."""
    from benchmark import spec

    r0 = results[0]
    ctx = {"cell": cell, "ranks": results, "rank0": r0,
           "setup_s": r0["t0"] - t_start}
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    check = r0["check"]
    device = {"platform": "gpu", "kind": r0["device_name"],
              "count": len(results),
              "memory_peak_bytes": max(r["peak_bytes"] for r in results)}
    out = {"correct": bool(check["correct"]), "attempted": r0["steps"],
           "failed": 0, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = statistics.fmean(r["trace"]["busy_s"]
                                            for r in results)
        device["window_s"] = statistics.fmean(r["trace"]["window_s"]
                                              for r in results)
        out["breakdown"] = {"device_ops": r0["trace"]["device_ops"],
                            "idle_gaps": r0["trace"]["idle_gaps"]}
    out["checks"] = {k: {"value": check["numbers"][k], "limit": v}
                     for k, v in cell.limits.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness, spec
    from dpc_tpu_torch.parallel import mesh

    cell = spec.load(args.workload)
    world = cell.traffic["ranks"]
    if world != cell.chips:
        print(f"cell {cell.name}: traffic has {world} ranks, cell asks for "
              f"{cell.chips} chips", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"cell {cell.name} needs {world} CUDA cards; "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        return 2
    params = {"workload": args.workload, "root": ROOT, "seed": args.seed,
              "seconds": args.seconds, "trace": bool(args.trace),
              "world": world, "device": "cuda"}
    if world == 1:
        results = [harness.rank_run(0, params)]
    else:
        results = mesh.run_ranks(harness.rank_run, world, (params,),
                                 backend="nccl")
    return report(cell, results, bool(args.trace), T_START)


def report(cell, results: list, trace: bool, t_start: float) -> int:
    """Print the result of the ranks' returns (``harness.rank_run``'s) and
    return 0; or, where this process or a rank has loaded one of
    ``harness.BANNED``, name it on standard error, print no result and
    return 3."""
    from benchmark import harness

    found = {"reporting process": harness.banned_modules()}
    found.update({f"rank {r['rank']}": r["banned"] for r in results})
    found = {k: v for k, v in found.items() if v}
    if found:
        print(f"loaded: {found}; no result", file=sys.stderr)
        return 3
    out = result(cell, results, trace, t_start)
    check = results[0]["check"]
    print(f"[card] {power_limit()}", file=sys.stderr)
    readings = {k: v for k, v in check["numbers"].items()
                if k not in cell.limits}
    readings.update(check["readings"])
    print(f"[check] not compared: {json.dumps(readings)}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
