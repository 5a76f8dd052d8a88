"""Readings that the correctness check's limits are set from, many seeds in
one process: the numbers ``compare.numbers`` gives, and the finer
readings behind them (every step's loss gap, the median leaf's gaps, the
worst leaves), one JSON line a seed.

  python3 benchmark/calibrate.py --workload <cell> --side <side> \
      --seeds 11,12,13 [--out FILE]

``--side program``: the system's first steps, through the window's own
call and feed, against the reference (one-rank cells).  ``--side float8``:
the control, the reference computed in float8 (``reference.precision``)
put in the system's place; ``--side bfloat16`` the witness of the
system's own rounding.  ``--side fault:<name>``: the reference with
one of ``reference.steps.FAULTS`` planted, in the system's place.  The
control and the faults run the cell's every shard on one card.  Not part
of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import compare, harness, spec  # noqa: E402


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = spec.load(args.workload, ROOT)
    world = cell.traffic["ranks"]
    device = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    torch.set_num_threads(1)
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        job = cell.traffic["job"]
        if args.side == "program":
            if world != 1:
                raise SystemExit("--side program runs one-rank cells")
            run = harness.Run(cell, seed, 0, device, None)
            got = run.check_steps()
            del run
        elif args.side in ("float8", "bfloat16"):
            got = harness.reference_readings(cell, job, seed, world, device,
                                             args.side)
        elif args.side.startswith("fault:"):
            got = harness.reference_readings(cell, job, seed, world, device,
                                             fault=args.side[6:])
        else:
            raise SystemExit(f"unknown side {args.side!r}")
        free(device)
        ref = harness.reference_readings(cell, job, seed, world, device)
        nums, readings = compare.numbers(got, ref, job)
        line = {"workload": cell.name, "side": args.side, "seed": seed,
                "numbers": nums, "readings": readings,
                "loss": got["loss"], "loss_ref": ref["loss"]}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        del got, ref
        free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
