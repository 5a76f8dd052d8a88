"""What a cell is made of, found by the names in ``BENCHMARK.json``: the
configuration's file, the traffic file ``benchmark/traffic/<traffic>.json``,
the limits of its correctness check ``benchmark/limits/<cell>.json``, and
one reader ``benchmark/metrics/<metric>.py`` for each metric it reports.
A later cell, traffic mix, configuration or metric is added by adding
files and entries; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the metric entries of BENCHMARK.json it reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name, w["chips"], config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def job(name: str):
    """The ``Job`` class of ``benchmark/jobs/<name>.py``."""
    return importlib.import_module(f"benchmark.jobs.{name}").Job
