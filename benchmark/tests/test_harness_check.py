"""The correctness check on the CPU at a small size.

The reference agrees with the system's CPU path over the same weights,
windows, labels and draws.  Driven through a whole run (set-up, the first
steps, warm-up, a short window, the reference) with the system's timed
path broken underneath, ``correct`` comes out false for each fault a cell
can have: the step leaves its state unchanged; half of the batch left
out, the mean taken over the rest; the exchange between ranks left out
(four gloo ranks); the loss altered where it is produced.  The cell's own
limits are used (``benchmark/limits``).  A rank that loads JAX stops the
result from being printed."""

from __future__ import annotations

import json
import sys
import types

import pytest
import torch

from benchmark import harness, run
from benchmark.tests.conftest import tiny_cell
from dpc_tpu_torch.ops import nce, nce_cuda
from dpc_tpu_torch.parallel import collectives, mesh as meshlib
from dpc_tpu_torch.train import finetune_step

LIMITS = {"pretrain": "r18-128-pretrain-b64",
          "finetune": "r18-128-finetune-b128"}
SEED = 2 ** 33 + 7


def _run(cell, rank_fn=harness.rank_run):
    params = {"cell": cell, "seed": SEED, "seconds": 0.5, "trace": False,
              "world": cell.traffic["ranks"], "device": "cpu"}
    if params["world"] == 1:
        return [rank_fn(0, params)]
    return meshlib.run_ranks(rank_fn, params["world"], (params,))


@pytest.mark.parametrize("job", ["pretrain", "finetune"])
def test_reference_agrees_with_the_cpu_path(job):
    cell = tiny_cell(job)
    run = harness.Run(cell, SEED, 0, torch.device("cpu"), None)
    got = run.check_steps()
    del run
    nums = harness.check(cell, job, SEED, 1, got, torch.device("cpu"))[
        "numbers"]
    assert nums["recipe_gap"] < 1e-5
    assert nums["embed_gap"] < 1e-4
    assert nums["loss_gap"] < 1e-5
    assert nums["loss_on_outputs_gap"] < 1e-5
    assert nums["head_grad_dist"] < 1e-3


@pytest.mark.parametrize("job", ["pretrain", "finetune"])
def test_sound_run_is_correct(job):
    out = _run(tiny_cell(job, limits_of=LIMITS[job]))[0]
    assert out["check"]["correct"], out["check"]
    assert out["steps"] > 0


def _half_rows(fn):
    def half(score, targets, *a, **k):
        n = score.shape[0] // 2
        return fn(score[:n], targets[:n], *a, **k)
    return half


def _altered(fn, factor=1.01):
    def altered(*a, **k):
        loss, metrics = fn(*a, **k)
        return loss * factor, metrics
    return altered


def _plant(monkeypatch, job, fault):
    if fault == "frozen":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif job == "pretrain" and fault == "half":
        monkeypatch.setattr(nce, "nce_loss", _half_rows(nce.nce_loss))
    elif job == "pretrain" and fault == "answer":
        monkeypatch.setattr(nce, "nce_loss", _altered(nce.nce_loss))
        monkeypatch.setattr(nce_cuda, "fused_nce_loss",
                            _altered(nce_cuda.fused_nce_loss))
    elif job == "finetune" and fault == "half":
        xent = finetune_step.softmax_xent
        monkeypatch.setattr(finetune_step, "softmax_xent",
                            lambda lg, lb: xent(lg[:len(lg) // 2],
                                                lb[:len(lb) // 2]))
    elif job == "finetune" and fault == "answer":
        xent = finetune_step.softmax_xent
        monkeypatch.setattr(finetune_step, "softmax_xent",
                            lambda lg, lb: xent(lg, lb) * 1.01)


@pytest.mark.parametrize("fault", ["frozen", "half", "answer"])
@pytest.mark.parametrize("job", ["pretrain", "finetune"])
def test_fault_is_not_correct(job, fault, monkeypatch):
    _plant(monkeypatch, job, fault)
    out = _run(tiny_cell(job, limits_of=LIMITS[job]))[0]
    assert not out["check"]["correct"], out["check"]


def rank_run_without_exchange(rank, params):
    """A rank whose gradient and metric mean across ranks is left out."""
    collectives.mean_flat_ = lambda tensors, group: None
    return harness.rank_run(rank, params)


def rank_run_loading_jax(rank, params):
    """A rank that loads a module named ``jax`` while it runs."""
    if rank == 2:
        sys.modules["jax"] = types.ModuleType("jax")
    return harness.rank_run(rank, params)


def _report(cell, results, capsys) -> tuple[int, str]:
    capsys.readouterr()
    rc = run.report(cell, results, False, 0.0)
    return rc, capsys.readouterr().out


def test_four_ranks_sound_and_without_exchange(capsys):
    cell = tiny_cell("pretrain", ranks=4, limits_of=LIMITS["pretrain"])
    sound = _run(cell)
    assert sound[0]["check"]["correct"], sound[0]["check"]
    assert len({r["steps"] for r in sound}) == 1  # the ranks agreed
    rc, out = _report(cell, sound, capsys)
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["correct"]
    broken = _run(cell, rank_run_without_exchange)
    assert not broken[0]["check"]["correct"], broken[0]["check"]


def test_a_rank_loading_jax_prints_no_result(capsys):
    cell = tiny_cell("pretrain", ranks=4, limits_of=LIMITS["pretrain"])
    results = _run(cell, rank_run_loading_jax)
    assert [r["banned"] for r in results] == [[], [], ["jax"], []]
    rc, out = _report(cell, results, capsys)
    assert rc != 0 and out == ""
