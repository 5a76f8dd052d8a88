"""The operation counters of ``benchmark/counts.py`` against PyTorch's
``FlopCounterMode`` on the reference at a small size: the forward, and the
train step's forward and backward (no recomputation)."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, feed
from benchmark.reference import model as M
from benchmark.reference.precision import Precision
from benchmark.weights import make_weights
from benchmark.tests.conftest import tiny_cell


def _inputs(cell):
    cfg, t = cell.config, cell.traffic
    x = torch.randn(t["batch"], cfg["num_seq"], cfg["seq_len"],
                    cfg["img_dim"], cfg["img_dim"], 3)
    labels = feed.make_labels(3, 0, 0, cfg, t, torch.device("cpu"))
    return x, labels


@pytest.mark.parametrize("network", ["resnet18", "resnet34", "resnet50"])
@pytest.mark.parametrize("job", ["pretrain", "finetune"])
def test_counts_match_flop_counter(job, network, monkeypatch):
    monkeypatch.setattr(M, "REMAT", False)  # count no recomputation
    cell = tiny_cell(job)
    cfg = dict(cell.config, network=network)
    d = M.feature_size(network)
    b = cell.traffic["batch"]
    p = {k: v.requires_grad_(True) for k, v in
         make_weights(cfg, job, 1, torch.device("cpu")).items()}
    x, labels = _inputs(cell)
    prec = Precision()
    fwd = (counts.pretrain_forward if job == "pretrain"
           else counts.finetune_forward)(cfg, b, d)
    with FlopCounterMode(display=False) as fc:
        if job == "pretrain":
            pred, gt = M.dpc_forward(prec, p, cfg, x, None)
            loss, _ = M.nce_loss(prec, pred, gt)
        else:
            loss, _ = M.xent_loss(M.lc_forward(prec, p, cfg, x, None),
                                  labels)
    assert fc.get_total_flops() == pytest.approx(sum(fwd.values()), rel=1e-9)
    with FlopCounterMode(display=False) as fc:
        loss.backward()
    total = sum(fwd.values()) + fc.get_total_flops()
    assert total == pytest.approx(counts.train_step_flops(cfg, job, b, d),
                                  rel=1e-9)


def test_stem_cost_counts_forward_and_weight_gradient():
    cell = tiny_cell("pretrain")
    cfg, b = cell.config, cell.traffic["batch"]
    x = torch.randn(b * cfg["num_seq"], 3, cfg["seq_len"], cfg["img_dim"],
                    cfg["img_dim"])
    w = torch.randn(64, 3, 1, 7, 7, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        y = torch.nn.functional.conv3d(x, w, None, (1, 2, 2), (0, 3, 3))
        y.sum().backward()
    flops, nbytes = counts.stem_cost(cfg, b)
    assert fc.get_total_flops() == pytest.approx(flops, rel=1e-9)
    frames = x.numel() * 4
    assert nbytes > 2 * frames
