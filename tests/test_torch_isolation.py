"""dpc_tpu_torch stands alone: no module of it (nor chip_smoke.py) imports
JAX, dpc_tpu, OpenCV, PIL or tensorboardX (the card's machine is not
assumed to have them), and its entry points refuse CUDA on a machine
without a card instead of running on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "cv2", "PIL", "tensorboardX"):
    sys.modules[blocked] = None      # any import of them now raises
import dpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dpc_tpu_torch.__path__,
                                               "dpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules
                if k == "dpc_tpu" or k.startswith("dpc_tpu."))
assert not leaked, leaked
# the LC slice's modules, the pool kernels' wrapper without nvcc, and the
# frame pipeline, checkpoints and shared loop
for name in ("models.lc", "ops.maxpool_cuda", "train.finetune_step",
             "train.evaluate", "train.metrics", "native", "data.augment",
             "data.video_dataset", "data.frame_tree", "data.device_augment",
             "core.checkpoint", "train.loop"):
    assert "dpc_tpu_torch." + name in names, name
print(len(names))
"""


def test_port_imports_neither_jax_nor_dpc_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 33   # every module was imported


def test_chip_smoke_source_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for bad in ("import jax", "from jax", "import dpc_tpu\n", "from dpc_tpu.",
                "from dpc_tpu import", "import cv2", "import PIL",
                "from PIL", "tensorboardX"):
        assert bad not in src


def test_cuda_request_without_card_raises(monkeypatch):
    from dpc_tpu_torch.core.config import resolve_device
    from dpc_tpu_torch.train import evaluate, pretrain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.main(["--dataset", "synthetic", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--dataset", "synthetic", "--device", "cuda"])
    assert resolve_device("cpu").type == "cpu"
