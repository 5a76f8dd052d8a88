"""A run needs the card: without one it prints no result and exits
non-zero, and so it does in a directory that holds only the benchmark's
files.  A run on the card is the ``card`` test below."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.tests.conftest import ROOT

ARGS = ["--workload", "r18-128-pretrain-b64", "--seed", "3000000099",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def _has_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except json.JSONDecodeError:
        return False


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not _has_result(out.stdout)


@pytest.mark.card
def test_one_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
