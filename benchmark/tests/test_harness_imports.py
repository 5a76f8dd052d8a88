"""What the harness and the reference load: no module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``dpc_tpu`` (compared whole, since
``dpc_tpu_torch`` begins with ``dpc_tpu``); the reference loads nothing of
``dpc_tpu_torch`` either.  Read by importing in a fresh interpreter, and
by the import statements of every file under ``benchmark/``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "dpc_tpu"}
HARNESS = ["benchmark.run", "benchmark.harness", "benchmark.calibrate",
           "benchmark.jobs.pretrain", "benchmark.jobs.finetune",
           "benchmark.spec", "benchmark.tracing"]
REFERENCE = ["benchmark.reference.model", "benchmark.reference.steps",
             "benchmark.reference.recipe", "benchmark.reference.precision",
             "benchmark.compare", "benchmark.counts", "benchmark.feed",
             "benchmark.weights", "benchmark.peaks"]


def _loaded(modules: list[str]) -> set[str]:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0]\n"
            "                         for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("group, banned", [
    ("harness", BANNED), ("reference", BANNED | {"dpc_tpu_torch"})])
def test_loaded_modules(group, banned):
    modules = HARNESS if group == "harness" else REFERENCE
    loaded = _loaded(modules)
    assert not loaded & banned, loaded & banned
    if group == "harness":
        assert "dpc_tpu_torch" in loaded  # the system under test


def test_no_file_imports_banned_names():
    for f in sorted((ROOT / "benchmark").rglob("*.py")):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            top = {n.split(".")[0] for n in names}
            assert not top & BANNED, (f, top)
            if {"reference", "metrics"} & set(f.parts):
                assert "dpc_tpu_torch" not in top, f
