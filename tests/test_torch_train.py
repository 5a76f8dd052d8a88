"""The pretrain path end to end on the CPU: one f32 train step of the port
(``gru_impl="pallas"``, ``nce_impl="fused"``, plain kernel versions on
the CPU) against dpc_tpu's ``make_pretrain_step`` on a one-device mesh,
same weights, same batch, dropout off, and a three-step loss envelope;
the pretrain CLI; and the finetune / dense-test CLI.

Tolerances: loss 1e-4 relative and top-k exact (f32, two conv libraries).
The first Adam step moves every parameter by about lr·g/(|g| + eps), so
the post-Adam parameters compare the sign of every gradient.  Layers 1-2
feed batch-statistics BNs, whose gradients sum to zero per channel, so
some of their gradients are within f32 noise of zero (about 3e-3 of the
tensor's scale on this input) and may change sign.  Hence: at least 99.9%
of all parameters agree within 1% of lr, and every parameter within the
2·lr a sign flip can cost.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpc_tpu.core.config import DPCConfig as JaxDPCConfig
from dpc_tpu.core.config import TrainConfig as JaxTrainConfig
from dpc_tpu.models import dpc as jax_dpc
from dpc_tpu.parallel import mesh as meshlib
from dpc_tpu.train import optim as jax_optim
from dpc_tpu.train import pretrain_step as jax_step
from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
from dpc_tpu_torch.models import dpc
from dpc_tpu_torch.ops import _build
from dpc_tpu_torch.train import evaluate, optim, pretrain, pretrain_step
from dpc_tpu_torch.utils.weights import dpc_state_dict_from_jax

SHAPE = dict(img_dim=32, num_seq=3, seq_len=4, pred_step=1, gru_dropout=0.0)
B, LR, WD = 4, 1e-3, 1e-5


def test_one_train_step_matches_jax():
    jcfg = JaxDPCConfig(**SHAPE)
    jparams = jax_dpc.init_dpc(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).normal(
        size=(B, 3, 4, 32, 32, 3)).astype(np.float32)

    model = dpc.DPC(DPCConfig(**SHAPE))
    before = dpc_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    model.load_state_dict(before, strict=True)

    mesh = meshlib.make_mesh(1)
    jtcfg = JaxTrainConfig(batch_size=B, lr=LR, wd=WD, negatives="local")
    tx = jax_optim.pretrain_optimizer(jparams, LR, WD)
    state = meshlib.replicate(mesh, jax_step.TrainState(
        jparams, tx.init(jparams), jnp.zeros((), jnp.int32)))
    jstep = jax_step.make_pretrain_step(jcfg, jtcfg, mesh, tx)
    state, jm = jstep(state, meshlib.shard_batch(mesh, jnp.asarray(x)),
                      jax.random.PRNGKey(1))
    jafter = dpc_state_dict_from_jax(jax.tree.map(np.asarray, state.params))

    cfg = DPCConfig(**SHAPE, gru_impl="pallas")
    tcfg = TrainConfig(batch_size=B, lr=LR, wd=WD, nce_impl="fused")
    step = pretrain_step.make_pretrain_step(
        cfg, tcfg, model, optim.pretrain_optimizer(model, LR, WD))
    _build.reset_launches()
    tm = step(torch.tensor(x))
    assert _build.LAUNCHES == {k: 0 for k in _build.LAUNCHES}  # CPU: plain

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    for k in ("top1", "top3", "top5"):
        assert float(tm[k]) == float(jm[k]), k
    after = model.state_dict()
    close = total = 0
    for k, want in jafter.items():
        diff = ((after[k] - before[k]) - (want - before[k])).abs()
        assert diff.max() <= 2.05 * LR, k
        close += int((diff <= 1e-2 * LR).sum())
        total += diff.numel()
    assert close >= 0.999 * total, (close, total)


def test_unported_options_raise():
    model = dpc.DPC(DPCConfig(**SHAPE))
    opt = optim.pretrain_optimizer(model, LR, WD)
    for bad in (dict(negatives="global"), dict(model_parallel=2),
                dict(cross_replica_bn=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pretrain_step.make_pretrain_step(
                DPCConfig(**SHAPE), TrainConfig(batch_size=B, **bad),
                model, opt)


def test_cli_runs_two_steps_on_cpu(tmp_path, capsys):
    pretrain.main(["--device", "cpu", "--dataset", "synthetic",
                   "--img_dim", "32", "--num_seq", "3", "--seq_len", "4",
                   "--pred_step", "1", "--batch_size", "2",
                   "--synthetic_videos", "4", "--steps_per_epoch", "2",
                   "--epochs", "1", "--num_workers", "2",
                   "--nce_impl", "fused", "--compute_dtype", "float32",
                   "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("epoch 0: train")]
    assert line, out
    loss = float(line[0].split("loss")[1].split()[0])
    assert math.isfinite(loss) and "[epoch 0] 2 train steps in" in out
    assert list(tmp_path.glob("*/config.json"))
    with pytest.raises(SystemExit, match="ROADMAP"):
        pretrain.main(["--device", "cpu", "--dataset", "synthetic",
                       "--negatives", "global"])


def test_pretrain_loss_envelope_over_three_steps():
    """Three f32 steps of the port against dpc_tpu's make_pretrain_step,
    same weights and batches, dropout off.  Envelope, in the manner of
    tests/test_train_parity.py: the first loss to 1e-4 relative (one
    forward); the later ones to 5e-2, since after an Adam step a gradient
    within f32 noise of zero may flip the sign of its lr-sized update."""
    jcfg = JaxDPCConfig(**SHAPE)
    jparams = jax_dpc.init_dpc(jax.random.PRNGKey(2), jcfg)
    model = dpc.DPC(DPCConfig(**SHAPE))
    model.load_state_dict(
        dpc_state_dict_from_jax(jax.tree.map(np.asarray, jparams)),
        strict=True)
    mesh = meshlib.make_mesh(1)
    tx = jax_optim.pretrain_optimizer(jparams, LR, WD)
    state = meshlib.replicate(mesh, jax_step.TrainState(
        jparams, tx.init(jparams), jnp.zeros((), jnp.int32)))
    jstep = jax_step.make_pretrain_step(
        jcfg, JaxTrainConfig(batch_size=B, lr=LR, wd=WD, negatives="local"),
        mesh, tx)
    step = pretrain_step.make_pretrain_step(
        DPCConfig(**SHAPE, gru_impl="pallas"),
        TrainConfig(batch_size=B, lr=LR, wd=WD, nce_impl="fused"), model,
        optim.pretrain_optimizer(model, LR, WD))
    rng = np.random.default_rng(3)
    jl, tl = [], []
    for i in range(3):
        x = rng.normal(size=(B, 3, 4, 32, 32, 3)).astype(np.float32)
        state, jm = jstep(state, meshlib.shard_batch(mesh, jnp.asarray(x)),
                          jax.random.PRNGKey(i))
        jl.append(float(jm["loss"]))
        tl.append(float(step(torch.tensor(x))["loss"]))
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=5e-2)
    assert all(math.isfinite(v) for v in tl)


def _finetune_cli(tmp_path, *extra):
    evaluate.main(["--device", "cpu", "--dataset", "synthetic",
                   "--img_dim", "32", "--num_seq", "3", "--seq_len", "4",
                   "--num_workers", "2", "--compute_dtype", "float32",
                   "--log_dir", str(tmp_path), *extra])


def test_finetune_cli_trains_validates_and_tests_on_cpu(tmp_path, capsys):
    _finetune_cli(tmp_path, "--batch_size", "2", "--synthetic_videos", "4",
                  "--steps_per_epoch", "2", "--epochs", "1")
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("[epoch 0] 2 ")]
    assert line and "val loss" in line[0], out
    losses = [float(p.split()[0].rstrip(";")) for p in
              line[0].split("loss")[1:]]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert any(ln.startswith("epoch 0: train top1") and "| val top1" in ln
               for ln in out.splitlines()), out
    assert list(tmp_path.glob("*/config.json"))
    _finetune_cli(tmp_path, "--test", "random", "--synthetic_videos", "2")
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("[test] loss")]
    assert line and math.isfinite(float(line[0].split()[2].rstrip(";")))
    # 256-frame videos at ds 3 are 21 blocks of 4: 19 windows of 3 blocks
    assert "38 windows / 2 videos" in out
    assert list(tmp_path.glob("*/confusion_matrix.txt"))


@pytest.mark.parametrize("flag", [
    ["--model_parallel", "4", "--test", "random"], ["--model_parallel", "2"],
    ["--num_devices", "2", "--test", "random"], ["--num_devices", "4"],
    ["--multihost", "--test", "random"], ["--multihost", "--device_augment"],
    ["--model_parallel", "2", "--five_crop"], ["--num_devices", "2"],
    ["--multihost"]])
def test_finetune_cli_rejects_unported_flags(tmp_path, flag):
    args = ["--dataset", "synthetic", *flag]
    with pytest.raises(SystemExit, match="ROADMAP"):
        _finetune_cli(tmp_path, *args)
