"""Meters and the test-time accuracy records (a copy of the parts of
``dpc_tpu/train/metrics.py`` the evaluation driver uses).

Averages of per-step metrics with the reference's 5-update sliding
``local_avg`` (``utils/utils.py:77-113``), the per-class
accuracy table (``:116-137``), the confusion matrix (``:140-193``; saved
as text, without the plot) and the markdown log (``:28-36``).
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np


class AverageMeter:
    """Running sum, count and average, and ``local_avg``: the unweighted
    mean of the last ``history`` (5) updates, which the reference reports
    at the end of an epoch (``utils/utils.py:77-113``)."""

    def __init__(self, history: int = 5):
        self.sum = 0.0
        self.count = 0
        self._local: deque = deque(maxlen=history)

    def update(self, val: float, n: int = 1) -> None:
        self.sum += float(val) * n
        self.count += n
        self._local.append(float(val))

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    @property
    def local_avg(self) -> float:
        return float(np.mean(self._local)) if self._local else 0.0


class MetricBundle:
    """A dict of AverageMeters updated from metric dicts."""

    def __init__(self, history: int = 5):
        self.history = history
        self.meters: dict[str, AverageMeter] = {}

    def update(self, metrics: dict, n: int = 1) -> None:
        for k, v in metrics.items():
            self.meters.setdefault(
                k, AverageMeter(self.history)).update(float(v), n)

    def averages(self) -> dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def local_averages(self) -> dict[str, float]:
        return {k: m.local_avg for k, m in self.meters.items()}


class AccuracyTable:
    """Per-class accuracy (``utils/utils.py:116-137``)."""

    def __init__(self):
        self.dict: dict[int, dict[str, int]] = {}

    def print_table(self, label: str = "") -> None:
        for key in sorted(self.dict):
            e = self.dict[key]
            acc = e["correct"] / e["count"]
            print(f"{label}: {key:3d}: {e['count']:5d}: {acc:.3f}")


class ConfusionMeter:
    """Confusion matrix, prediction in rows and target in columns."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: np.ndarray, target: np.ndarray) -> None:
        for p, t in zip(np.asarray(pred).flatten(),
                        np.asarray(target).flatten()):
            self.mat[int(p), int(t)] += 1

    def save(self, path: str) -> None:
        np.savetxt(path, self.mat, fmt="%d")


def write_log(content: str, epoch: int, filename: str) -> None:
    """Append a markdown log entry (``utils/utils.py:28-36``)."""
    mode = "a" if os.path.exists(filename) else "w"
    with open(filename, mode) as f:
        f.write(f"## Epoch {epoch}:\n")
        f.write(f"time: {time.ctime()}\n")
        f.write(content + "\n\n")
