"""The port's torch checkpoints (``dpc_tpu_torch/core/checkpoint.py``) and
its validation step, held against ``dpc_tpu``.

Retention (rolling latest + best by val_acc), the mid-epoch id and resume
gate, atomic writes, and the interchange: an epoch file the port writes
loads through ``dpc_tpu``'s ``load_pretrained`` with the reference key map
to the port's parameters bit for bit, and computes the port's forward.  In
f32 the two packages' convolutions sum in different orders, so the DPC
forward agrees to 1.2e-5..4.8e-5 of its largest value even with weights
handed over directly; the forward is held to 1e-4 of it.  The validation
step (``pretrain_step.make_eval_step``) matches ``dpc_tpu``'s on a
1-device mesh: the loss within 1e-4, top-1/3/5 equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpc_tpu.core import checkpoint as jax_ckpt
from dpc_tpu.core.config import DPCConfig as JaxDPCConfig
from dpc_tpu.core.config import TrainConfig as JaxTrainConfig
from dpc_tpu.models import dpc as jax_dpc
from dpc_tpu.parallel import mesh as meshlib
from dpc_tpu.train import pretrain_step as jax_step
from dpc_tpu.utils import torch_compat
from dpc_tpu_torch.core import checkpoint as ckpt
from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
from dpc_tpu_torch.models import dpc, lc
from dpc_tpu_torch.train import optim, pretrain_step
from dpc_tpu_torch.utils.weights import dpc_state_dict_from_jax
from torch_threads import one_thread  # noqa: F401

SHAPE = dict(img_dim=32, num_seq=3, seq_len=4, pred_step=1, gru_dropout=0.0)
B = 4


def _payload(value: float) -> dict:
    return {"epoch": 0, "state_dict": {"w": torch.full((3,), value)},
            "best_acc": 0.0}


def test_retention_keeps_latest_and_best(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    for epoch, acc in zip((1, 2, 3, 4), (0.1, 0.5, 0.3, 0.5)):
        mgr.save(epoch, _payload(epoch), val_acc=acc)
    # strictly better only: epoch 4 ties epoch 2 and does not replace it
    assert sorted(os.listdir(tmp_path)) == ["epoch4.pth.tar",
                                            "model_best_epoch2.pth.tar"]
    assert mgr.latest_step() == 4 and mgr.best_step() == 2
    step, best = ckpt.restore_best(mgr)
    assert step == 2 and best["val_acc"] == 0.5
    assert torch.equal(best["state_dict"]["w"], torch.full((3,), 2.0))
    step, latest = ckpt.restore_latest(mgr)
    assert step == 4 and float(latest["state_dict"]["w"][0]) == 4.0
    mgr.save(5, _payload(5), val_acc=0.9)
    assert sorted(os.listdir(tmp_path)) == ["epoch5.pth.tar",
                                            "model_best_epoch5.pth.tar"]
    assert ckpt.restore_latest(ckpt.CheckpointManager(
        str(tmp_path / "empty"))) == (None, None)
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(str(tmp_path / "nowhere"), read_only=True)


@pytest.mark.parametrize("offset", [0, 7, 123456])
def test_mid_epoch_step_id_matches_dpc_tpu(offset):
    for epoch in (0, 1, 5, 299):
        for batch in (0, 1, 99, 9537, 99999):
            assert ckpt.mid_epoch_step_id(epoch, batch, offset) == \
                jax_ckpt.mid_epoch_step_id(epoch, batch, offset)
    with pytest.raises(ValueError):
        ckpt.mid_epoch_step_id(0, 100000)


def test_resume_mid_epoch_gate_and_dedupe(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_best=False,
                                 step_files=True)
    assert ckpt.resume_mid_epoch(mgr, 3) == (None, 3, 0)
    sid = ckpt.mid_epoch_step_id(2, 4)
    ckpt.save_step_unless_duplicate(
        mgr, sid, lambda: {"epoch": 2, "batch_idx": 4, "v": 1})
    # a duplicate request builds no payload and rewrites nothing
    ckpt.save_step_unless_duplicate(mgr, sid, lambda: 1 / 0)
    payload, epoch, batch = ckpt.resume_mid_epoch(mgr, 2)
    assert (payload["v"], epoch, batch) == (1, 2, 5)
    # an epoch file written later supersedes the stale step file
    assert ckpt.resume_mid_epoch(mgr, 3) == (None, 3, 0)
    ckpt.save_step_unless_duplicate(
        mgr, ckpt.mid_epoch_step_id(2, 5), lambda: {"epoch": 2,
                                                    "batch_idx": 5})
    assert os.listdir(tmp_path) == [f"step{sid + 1}.pth.tar"]


def test_writes_are_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / "epoch1.pth.tar")
    ckpt.atomic_save(_payload(1.0), path)

    def broken(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.atomic_save(_payload(2.0), path)
    assert os.listdir(tmp_path) == ["epoch1.pth.tar"]  # no temp file left
    assert float(ckpt.load_file(path)["state_dict"]["w"][0]) == 1.0


def test_port_checkpoint_loads_into_dpc_tpu(tmp_path):
    """An epoch file of the port's pretrain layout, read by dpc_tpu's
    load_pretrained through the reference key map, computes the port's
    forward."""
    cfg = DPCConfig(**SHAPE)
    torch.manual_seed(0)
    model = dpc.DPC(cfg)
    opt = optim.pretrain_optimizer(model, 1e-3, 1e-5)
    mgr = ckpt.CheckpointManager(str(tmp_path / "model"))
    mgr.save(1, {"epoch": 1, "net": cfg.network,
                 "state_dict": model.state_dict(),
                 "optimizer": opt.state_dict(), "best_acc": 0.0,
                 "iteration": 0}, val_acc=0.0)
    jcfg = JaxDPCConfig(**SHAPE)
    template = jax_dpc.init_dpc(jax.random.PRNGKey(1), jcfg)
    params = jax_ckpt.load_pretrained(str(tmp_path / "model" /
                                          "epoch1.pth.tar"),
                                      template, torch_compat.dpc_key_map,
                                      verbose=False)
    read = dpc_state_dict_from_jax(jax.tree.map(np.asarray, params))
    assert read.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(read[k], v), k
    x = np.random.default_rng(0).normal(
        size=(2, 3, 4, 32, 32, 3)).astype(np.float32)
    jscore, jpred, _ = jax.jit(lambda p, v: jax_dpc.apply_dpc(
        p, v, cfg=jcfg, train=False))(params, jnp.asarray(x))
    with torch.no_grad():
        score, pred, _ = dpc.apply_dpc(model, torch.tensor(x), cfg=cfg,
                                       train=False)
    for got, want in ((score, jscore), (pred, jpred)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-4, err


def test_transfer_load_reads_reference_files(tmp_path, capsys):
    """--pretrain: a reference-style .pth.tar (DataParallel's ``module.``
    prefix, a DPC tree) fills the LC trunk by name and leaves the head."""
    cfg = DPCConfig(**SHAPE)
    torch.manual_seed(0)
    source = dpc.DPC(cfg)
    path = str(tmp_path / "dpc.pth.tar")
    torch.save({"epoch": 3, "state_dict": {
        f"module.{k}": v for k, v in source.state_dict().items()}}, path)
    target = lc.LC(cfg, 8)
    head = target.final_fc[1].weight.clone()
    ckpt.load_pretrained(path, target)
    out = capsys.readouterr().out
    assert "[transfer_load] loaded" in out and "missing: final_fc" in out
    for k, v in source.state_dict().items():
        if k.startswith(("backbone.", "agg.")):
            assert torch.equal(target.state_dict()[k], v), k
    assert torch.equal(target.final_fc[1].weight, head)
    sd, epoch = ckpt.state_dict_of(path)
    assert epoch is None and "backbone.conv1.weight" in sd
    with pytest.raises(FileNotFoundError):
        ckpt.state_dict_of(str(tmp_path / "empty_run"))


@pytest.mark.parametrize("nce_impl", ["fused", "xla"])
def test_eval_step_matches_dpc_tpu(nce_impl):
    jcfg = JaxDPCConfig(**{**SHAPE, "gru_dropout": 0.1})
    jparams = jax_dpc.init_dpc(jax.random.PRNGKey(0), jcfg)
    model = dpc.DPC(DPCConfig(**SHAPE))
    model.load_state_dict(
        dpc_state_dict_from_jax(jax.tree.map(np.asarray, jparams)),
        strict=True)
    x = np.random.default_rng(1).normal(
        size=(B, 3, 4, 32, 32, 3)).astype(np.float32)
    mesh = meshlib.make_mesh(1)
    jeval = jax_step.make_eval_step(
        jcfg, JaxTrainConfig(batch_size=B, negatives="local"), mesh)
    jm = jeval(meshlib.replicate(mesh, jparams),
               meshlib.shard_batch(mesh, jnp.asarray(x)),
               jax.random.PRNGKey(2))
    # GRU dropout is configured on: the eval step must draw none
    cfg = DPCConfig(**{**SHAPE, "gru_dropout": 0.1}, gru_impl="pallas")
    eval_step = pretrain_step.make_eval_step(
        cfg, TrainConfig(batch_size=B, nce_impl=nce_impl), model)
    tm = eval_step(torch.tensor(x))
    assert not any(p.grad is not None for p in model.parameters())
    # the loss inherits the forward's f32 agreement (the convolutions sum
    # in another order: 1.1e-5 relative with one torch thread), so it is
    # held to the train step's 1e-4 (test_torch_train.py); the top-k
    # accuracies must be equal
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    for k in ("top1", "top3", "top5"):
        assert float(tm[k]) == float(jm[k]), k


@pytest.mark.parametrize("history", [5, 3])
def test_local_average_meter_matches_dpc_tpu(history):
    """The meters' sliding ``local_avg`` (the unweighted mean of the last
    ``history`` updates, the reference's epoch summary) and the weighted
    ``avg`` against ``dpc_tpu.train.metrics`` over uneven batch sizes."""
    from dpc_tpu.train import metrics as jax_metrics
    from dpc_tpu_torch.train import metrics

    ours, ref = metrics.MetricBundle(history), jax_metrics.MetricBundle(
        history)
    assert ours.local_averages() == ref.local_averages() == {}
    rng = np.random.default_rng(history)
    for i in range(9):
        m = {"loss": float(rng.random() * 5), "top1": float(rng.random())}
        n = int(rng.integers(1, 8))
        ours.update(m, n)
        ref.update(m, n)
        assert ours.local_averages() == pytest.approx(ref.local_averages(),
                                                      rel=1e-12)
        assert ours.averages() == pytest.approx(ref.averages(), rel=1e-12)
    assert ours.local_averages()["loss"] != pytest.approx(
        ours.averages()["loss"])
