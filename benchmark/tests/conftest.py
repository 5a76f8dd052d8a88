"""The benchmark's own test settings (``python -m pytest benchmark/tests``):
one torch thread, the ``card`` marker for the tests that need a CUDA card
(they skip inside the test without one), and a tiny cell of each job on
the CPU.  Nothing here imports JAX."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without")


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny_cell(job: str, ranks: int = 1, limits_of: str = ""):
    """A cell of ``job`` small enough for the CPU: the R18 configuration at
    32x32, 4 blocks of 4 frames, pred 2, float32, 4 clips a rank; the
    limits of ``limits_of`` (a cell of BENCHMARK.json)."""
    from benchmark import spec

    cfg = json.loads((ROOT / "benchmark/configs/dpc-r18-128.json").read_text())
    cfg.update(img_dim=32, num_seq=4, seq_len=4, pred_step=2,
               compute_dtype="float32")
    traffic = {"job": job, "ranks": ranks, "batch": 4, "window": [40, 52],
               "recipe": "sized_crop", "ring": 3}
    limits = {}
    if limits_of:
        limits = json.loads((ROOT / f"benchmark/limits/{limits_of}.json")
                            .read_text())
    return spec.Cell("tiny", ranks, cfg, traffic, limits, [], [])
