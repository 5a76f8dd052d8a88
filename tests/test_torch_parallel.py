"""The port's multi-rank pretraining and LC finetune on CPU ranks (gloo,
one thread a rank) against ``dpc_tpu``'s ``shard_map`` steps on the
virtual 8-device mesh (Pallas in interpret mode), same weights, same
numpy-seeded inputs, f32, ``DPCConfig(img_dim=32, num_seq=3, seq_len=4,
pred_step=1, gru_dropout=0.0)``, B=8; the LC with 11 classes and dropout
off, and the dense test of 5 synthetic videos on 2 ranks against 1 rank
and against ``dpc_tpu``'s ``run_test`` on one device.

The port's ranks are spawned twice for the whole module (2 ranks for the
``{data:2}`` layouts, 4 for ``{data:2, model:2}``), in background threads
while ``dpc_tpu`` makes the weights (the ranks wait for them) and
compiles its programs; each rank runs every task of its job and returns
small results, rank 0 its updated parameters in a file.  The 2-rank job
also runs the finetune CLI three times in its process group, as
torchrun's ranks would: one epoch, the resume, the dense test.  The SGD
update norm of a layout is the norm of the gradient its step averaged
over the ranks (an SGD(lr=1) step moves the parameters by it; Adam
leaves ``.grad`` as it is), read after the Adam step.

Tolerances: K7 lse and gradients 1e-5 relative, ranks exact; the sharded
loss 1e-5 relative, top-k exact, d(pred) and d(gt) 1e-4 of the largest;
group BN outputs and gradients 1e-5 of the largest; the steps' loss and
top-k 1e-4 relative.  The Adam step moves a parameter by about
lr·g/(|g| + eps), so the updated parameters compare gradient signs, and
at this size the gradients carry f32 noise of up to 2% of a tensor's
largest (the port against itself on 1 and 7 threads, batch-statistics BN
over a few elements), which flips the sign of about 0.15% of the Adam
updates against dpc_tpu's (measured: 99.86% within 1e-4 of the largest
parameter, update cosine 0.9968, at ``{data:2}`` global).  So: every
parameter within the 2·lr that a flipped sign costs, the two updates'
cosine at least 0.99, and 99.5% of the parameters within 1e-4 of the
largest; a step that averaged the wrong gradients would move about half
of them the other way.  The SGD update-norm ratio of ``{data:2, model:2}`` to
``{data:2}`` is 1 within 1e-3 (a psum where the model mean belongs
doubles it).  The LC steps: loss and top-k 1e-4 relative, the BN running
statistics within 1e-5 of each tensor's largest, the updated parameters
as above, the SGD ratio of ``{data:2, model:2}`` to ``{data:2}`` 1 within
1e-3; the 2-D group BN (the LC head's ``final_bn``) 1e-5 of the largest;
the dense test's loss 1e-4 relative, top-1, top-5 and the confusion
matrix equal.  The fused stem over the 2-rank group (``layers.fused_stem``
with ``group``, against ``dpc_tpu``'s ``fused_stem(axis_name=...)``):
outputs 1e-5 and the gradients 2e-4 of the largest (tests/test_torch_stem.py's
tolerances), the running statistics of its LC train mode 1e-5.
"""

import contextlib
import io
import math
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dpc_tpu.core.config import DPCConfig as JaxDPCConfig
from dpc_tpu.core.config import EvalConfig as JaxEvalConfig
from dpc_tpu.core.config import TrainConfig as JaxTrainConfig
from dpc_tpu.models import dpc as jax_dpc
from dpc_tpu.models import layers as jax_layers
from dpc_tpu.models import lc as jax_lc
from dpc_tpu.ops import nce_pallas
from dpc_tpu.ops import sharded_nce as jax_sharded_nce
from dpc_tpu.parallel import mesh as jax_mesh
from dpc_tpu.train import evaluate as jax_evaluate
from dpc_tpu.train import finetune_step as jax_ft
from dpc_tpu.train import optim as jax_optim
from dpc_tpu.train import pretrain_step as jax_step
from dpc_tpu_torch.core.config import DPCConfig, EvalConfig, TrainConfig
from dpc_tpu_torch.models import dpc, layers, lc
from dpc_tpu_torch.ops import nce_cuda, sharded_nce
from dpc_tpu_torch.parallel import dryrun
from dpc_tpu_torch.parallel import mesh as meshlib
from dpc_tpu_torch.train import (evaluate, finetune_step, optim, pretrain,
                                 pretrain_step)
from dpc_tpu_torch.utils.weights import (dpc_state_dict_from_jax,
                                         lc_state_dict_from_jax)
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(img_dim=32, num_seq=3, seq_len=4, pred_step=1, gru_dropout=0.0)
B, LR, WD = 8, 1e-3, 1e-5
# name: (ranks, model axis, the port's TrainConfig fields; dpc_tpu runs
# the same layout with nce_impl="xla")
LAYOUTS = {
    "data2_local": (2, 1, dict(negatives="local", nce_impl="fused")),
    "data2_global": (2, 1, dict(negatives="global", nce_impl="fused")),
    "data2_xbn": (2, 1, dict(negatives="local", nce_impl="xla",
                             cross_replica_bn=True)),
    "data2_model2": (4, 2, dict(negatives="global", nce_impl="fused")),
}
NCE_SHAPE = (8, 3, 2, 2, 16)   # pred, gt: [B, P, S, S, D] over data=2
BN_SHAPE = (8, 2, 3, 3, 8)     # channels-last x of the group BN, 4 ranks
BN2_SHAPE = (8, 16)            # the LC head's [B, D] features, 4 ranks
STEM_X = (4, 2, 16, 16, 3)     # the fused stem's input, 2 ranks
STEM_C = 8
CLASSES, FT_WD = 11, 1e-3
# the LC layouts: name: (ranks, model axis)
FT_LAYOUTS = {"ft_data2": (2, 1), "ft_data2_model2": (4, 2)}
# the dense test of both packages' CLIs, 5 synthetic videos of 19 windows
TEST_ARGS = ["--dataset", "synthetic", "--img_dim", "32", "--num_seq", "3",
             "--seq_len", "4", "--compute_dtype", "float32", "--num_class",
             str(CLASSES), "--synthetic_videos", "5", "--test", "random",
             "--num_devices", "1"]


def _inputs():
    rng = np.random.default_rng(0)
    out = {
        "x": rng.normal(size=(B, 3, 4, 32, 32, 3)).astype(np.float32),
        "pred": rng.normal(size=NCE_SHAPE).astype(np.float32),
        "gt": rng.normal(size=NCE_SHAPE).astype(np.float32),
        "bn_x": rng.normal(size=BN_SHAPE).astype(np.float32),
        "bn_ct": rng.normal(size=BN_SHAPE).astype(np.float32),
        "bn_w": rng.uniform(0.5, 1.5, size=BN_SHAPE[-1]).astype(np.float32),
        "bn_b": rng.normal(size=BN_SHAPE[-1]).astype(np.float32),
    }
    lc_rng = np.random.default_rng(1)
    return {**out,
            "lc_x": lc_rng.normal(size=(B, 3, 4, 32, 32, 3)).astype(
                np.float32),
            "lc_y": lc_rng.integers(0, CLASSES, size=B).astype(np.int64),
            "bn2_x": lc_rng.normal(2.0, 1.5, size=BN2_SHAPE).astype(
                np.float32),
            "bn2_ct": lc_rng.normal(size=BN2_SHAPE).astype(np.float32),
            "bn2_w": lc_rng.uniform(0.5, 1.5, size=BN2_SHAPE[-1]).astype(
                np.float32),
            "bn2_b": lc_rng.normal(size=BN2_SHAPE[-1]).astype(np.float32),
            **_stem_inputs()}


def _stem_inputs() -> dict:
    """The fused stem's case: channels with γ < 0 and a γ = 0 channel with
    β = 0.7 (``TestFusedStem``'s), running statistics for its LC mode."""
    rng = np.random.default_rng(30)
    gamma = rng.uniform(0.5, 1.5, STEM_C).astype(np.float32)
    gamma[::3] *= -1.0
    gamma[1] = 0.0
    beta = rng.normal(size=STEM_C).astype(np.float32)
    beta[1] = 0.7
    return {
        "stem_w": (rng.normal(size=(1, 7, 7, 3, STEM_C)) * 0.1).astype(
            np.float32),
        "stem_gamma": gamma, "stem_beta": beta,
        "stem_x": rng.normal(size=STEM_X).astype(np.float32),
        "stem_ct": rng.normal(size=(*STEM_X[:2], 4, 4, STEM_C)).astype(
            np.float32),
        "stem_mean": (rng.normal(size=STEM_C) * 0.3).astype(np.float32),
        "stem_var": rng.uniform(0.5, 2.0, STEM_C).astype(np.float32)}


# ---------------------------------------------------------------------------
# The port's ranks (spawned: module-level functions)
# ---------------------------------------------------------------------------

def _port_model(weights: str):
    model = dpc.DPC(DPCConfig(**SHAPE))
    model.load_state_dict(torch.load(weights, weights_only=True))
    return model


def _grad_norm(model) -> float:
    """The norm of the gradient the step averaged over the ranks, which
    is the norm of an SGD(lr=1) update (Adam leaves ``.grad`` as it is)."""
    return math.sqrt(sum(float((p.grad ** 2).sum())
                         for p in model.parameters() if p.grad is not None))


def _port_step(mesh, tmp: str, name: str, x: np.ndarray) -> dict:
    world, mp, fields = LAYOUTS[name]
    cfg = DPCConfig(**SHAPE, gru_impl="pallas")
    tcfg = TrainConfig(batch_size=B, lr=LR, wd=WD, model_parallel=mp,
                       **fields)
    model = _port_model(os.path.join(tmp, "weights.pt"))
    opt = optim.pretrain_optimizer(model, LR, WD)
    step = pretrain_step.make_pretrain_step(cfg, tcfg, model, opt, mesh)
    metrics = step(torch.from_numpy(meshlib.shard_batch(mesh, x)))
    if mesh.rank == 0:
        torch.save(model.state_dict(), os.path.join(tmp, f"{name}.pt"))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "digest": dryrun.param_digest(model), "norm": _grad_norm(model)}


def _port_nce(mesh, inp: dict) -> dict:
    out = {}
    d = mesh.data_index
    bl = NCE_SHAPE[0] // mesh.n_data
    for impl in ("xla", "fused"):
        pred = torch.tensor(inp["pred"][d * bl:(d + 1) * bl],
                            requires_grad=True)
        gt = torch.tensor(inp["gt"][d * bl:(d + 1) * bl], requires_grad=True)
        loss, metrics = sharded_nce.sharded_nce_loss(pred, gt, mesh,
                                                     impl=impl)
        loss.backward()
        out[impl] = {"loss": float(loss),
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "dpred": pred.grad.numpy(), "dgt": gt.grad.numpy()}
    return out


def _port_bn(mesh, inp: dict) -> dict:
    per = BN_SHAPE[0] // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    bn = layers.batchnorm3d(BN_SHAPE[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn_w"]))
        bn.bias.copy_(torch.from_numpy(inp["bn_b"]))
    x = torch.tensor(inp["bn_x"][rows]).permute(0, 4, 1, 2, 3)
    x.requires_grad_(True)
    y = layers.batchnorm(bn, x, mesh.world_group)
    ct = torch.from_numpy(inp["bn_ct"][rows]).permute(0, 4, 1, 2, 3)
    (y * ct).sum().backward()
    ema = layers.batchnorm3d(BN_SHAPE[-1], track_running_stats=True)
    layers.batchnorm(ema, x.detach(), mesh.world_group)
    return {"y": y.detach().permute(0, 2, 3, 4, 1).numpy(),
            "dx": x.grad.permute(0, 2, 3, 4, 1).numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "running": (ema.running_mean.numpy(), ema.running_var.numpy())}


def _port_eval(mesh, tmp: str, x: np.ndarray) -> dict:
    tcfg = TrainConfig(batch_size=B, negatives="global", model_parallel=2,
                       nce_impl="xla")
    model = _port_model(os.path.join(tmp, "weights.pt"))
    ev = pretrain_step.make_eval_step(DPCConfig(**SHAPE, gru_impl="pallas"),
                                      tcfg, model, mesh)
    return {k: float(v) for k, v in
            ev(torch.from_numpy(meshlib.shard_batch(mesh, x))).items()}


def _port_lc(tmp: str) -> lc.LC:
    model = lc.LC(DPCConfig(**SHAPE), CLASSES, dropout=0.0)
    model.load_state_dict(torch.load(os.path.join(tmp, "lc_weights.pt"),
                                     weights_only=True))
    return model


def _port_finetune(mesh, tmp: str, name: str, inp: dict) -> dict:
    ecfg = EvalConfig(num_classes=CLASSES, dropout=0.0, batch_size=B, lr=LR,
                      wd=FT_WD)
    model = _port_lc(tmp)
    opt = optim.finetune_optimizer(model, LR, FT_WD)
    step = finetune_step.make_finetune_step(
        DPCConfig(**SHAPE, gru_impl="pallas"), ecfg, model, opt, mesh)
    metrics = step(torch.from_numpy(meshlib.shard_batch(mesh, inp["lc_x"])),
                   torch.from_numpy(meshlib.shard_batch(mesh, inp["lc_y"])))
    if mesh.rank == 0:
        torch.save(model.state_dict(), os.path.join(tmp, f"{name}.pt"))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "digest": dryrun.param_digest(model),
            "norm": _grad_norm(model)}


def _port_ft_eval(mesh, tmp: str, inp: dict) -> dict:
    ev = finetune_step.make_finetune_eval_step(
        DPCConfig(**SHAPE, gru_impl="pallas"),
        EvalConfig(num_classes=CLASSES, batch_size=B), _port_lc(tmp), mesh)
    return {k: float(v) for k, v in ev(
        torch.from_numpy(meshlib.shard_batch(mesh, inp["lc_x"])),
        torch.from_numpy(meshlib.shard_batch(mesh, inp["lc_y"]))).items()}


def _port_bn2d(mesh, inp: dict) -> dict:
    per = BN2_SHAPE[0] // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    bn = torch.nn.BatchNorm1d(BN2_SHAPE[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn2_w"]))
        bn.bias.copy_(torch.from_numpy(inp["bn2_b"]))
    x = torch.tensor(inp["bn2_x"][rows], requires_grad=True)
    y = layers.batchnorm(bn, x, mesh.world_group)
    (y * torch.from_numpy(inp["bn2_ct"][rows])).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "running": (bn.running_mean.numpy(), bn.running_var.numpy())}


def _port_stem(mesh, inp: dict) -> dict:
    """The fused stem with its statistics over the 2 ranks: outputs and
    gradients of ``sum(y·ct)``, and the running statistics of its LC
    train mode."""
    per = STEM_X[0] // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    conv = torch.nn.Conv3d(3, STEM_C, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                           bias=False)
    out = {}
    for track in (False, True):
        bn = layers.batchnorm3d(STEM_C, track_running_stats=track)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(inp["stem_w"]).permute(
                4, 3, 0, 1, 2))
            bn.weight.copy_(torch.from_numpy(inp["stem_gamma"]))
            bn.bias.copy_(torch.from_numpy(inp["stem_beta"]))
            if track:
                bn.running_mean.copy_(torch.from_numpy(inp["stem_mean"]))
                bn.running_var.copy_(torch.from_numpy(inp["stem_var"]))
        x = torch.tensor(inp["stem_x"][rows]).permute(0, 4, 1, 2, 3)
        if track:
            with torch.no_grad():
                layers.fused_stem(conv, bn, x, group=mesh.world_group)
            out["running"] = (bn.running_mean.numpy(),
                              bn.running_var.numpy())
            continue
        x.requires_grad_(True)
        conv.zero_grad()
        y = layers.fused_stem(conv, bn, x, group=mesh.world_group)
        y = y.permute(0, 2, 3, 4, 1)
        (y * torch.from_numpy(inp["stem_ct"][rows])).sum().backward()
        out.update(y=y.detach().numpy(),
                   dx=x.grad.permute(0, 2, 3, 4, 1).numpy(),
                   dw=conv.weight.grad.permute(2, 3, 4, 1, 0).numpy(),
                   dgamma=bn.weight.grad.numpy(), dbeta=bn.bias.grad.numpy())
    return out


def _read_test(exp_dir: str) -> dict:
    """top-5 from ``test_log.md`` and the confusion matrix (either
    package's run_test writes both)."""
    log = Path(exp_dir, "test_log.md").read_text()
    mat = Path(exp_dir, "confusion_matrix.txt")
    return {"top5": float(log.split("top5: ")[-1].split()[0]),
            "confusion": np.loadtxt(mat, dtype=np.int64) if mat.exists()
            else None}


def _port_test(mesh, tmp: str) -> dict:
    """``run_test`` on this job's ranks (the window batch 8 a rank), then
    on rank 0 alone with no mesh."""
    cfg = evaluate.config_from_args(evaluate.build_parser().parse_args(
        TEST_ARGS))
    model = _port_lc(tmp)
    out = {}
    for n, m in ((mesh.size, mesh), (1, None)):
        if m is None and mesh.rank:
            break
        exp_dir = os.path.join(tmp, f"test{n}")
        loss, top1 = evaluate.run_test(cfg, model, exp_dir,
                                       window_batch=8 * n, mesh=m)
        out[n] = {"loss": loss, "top1": top1, "exp_dir": exp_dir}
        if mesh.rank == 0:
            out[n].update(_read_test(exp_dir))
    return out


FT_CLI = ["--device", "cpu", "--dataset", "synthetic", "--img_dim", "32",
          "--num_seq", "3", "--seq_len", "4", "--batch_size", "4",
          "--synthetic_videos", "8", "--num_workers", "1", "--compute_dtype",
          "float32", "--print_freq", "1", "--steps_per_epoch", "2",
          "--num_class", "8"]


def _finetune_cli(tmp: str) -> dict:
    """The finetune CLI three times in this rank's process group, as
    torchrun's ranks run it: one epoch, the resume into a second, and the
    dense test of the run.  Returns what this rank printed."""
    log_dir = os.path.join(tmp, "cli")
    out = {}
    for what, argv in (("train", ["--epochs", "1", "--log_dir", log_dir]),
                       ("resume", ["--epochs", "2", "--resume"]),
                       ("test", ["--synthetic_videos", "5", "--test"])):
        if what != "train":
            (run,) = Path(log_dir).glob("*")
            argv = argv + [str(run), "--log_dir", os.path.join(tmp, "cli_t")]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            evaluate.main(FT_CLI + argv)
        out[what] = buf.getvalue()
    return {**out, "run": str(run), "test_dir": os.path.join(tmp, "cli_t")}


def _port_job(rank: int, tmp: str, inp: dict) -> dict:
    world = torch.distributed.get_world_size()
    mesh = meshlib.make_mesh(0, model_parallel=2 if world == 4 else 1)
    out = {}
    if world == 4:
        out["nce"] = _port_nce(mesh, inp)
        out["bn"] = _port_bn(mesh, inp)
        out["bn2d"] = _port_bn2d(mesh, inp)
        out["dryrun"] = dryrun._dryrun_rank(rank, 2, 4)
    # the weights are written while the ranks start
    while not os.path.exists(os.path.join(tmp, "ready")):
        time.sleep(0.05)
    if world == 4:
        out["eval"] = _port_eval(mesh, tmp, inp["x"])
        out["ft_eval"] = _port_ft_eval(mesh, tmp, inp)
    else:
        out["stem"] = _port_stem(mesh, inp)
        out["test"] = _port_test(mesh, tmp)
    for name, (n, _, _) in LAYOUTS.items():
        if n == world:
            out[name] = _port_step(mesh, tmp, name, inp["x"])
    for name, (n, _) in FT_LAYOUTS.items():
        if n == world:
            out[name] = _port_finetune(mesh, tmp, name, inp)
    if world == 2:
        out["cli"] = _finetune_cli(tmp)
        with contextlib.redirect_stdout(io.StringIO()):
            out["preempted"] = _preempted_rank(rank, FT_CLI + [
                "--epochs", "1", "--synthetic_videos", "16",
                "--steps_per_epoch", "4", "--save_every_steps", "100",
                "--log_dir", os.path.join(tmp, "cli_p")], evaluate.main)
    return out


# ---------------------------------------------------------------------------
# dpc_tpu's side
# ---------------------------------------------------------------------------

def _jax_steps(jparams, x) -> dict:
    jcfg = JaxDPCConfig(**SHAPE)
    out = {}
    for name, (n, mp, fields) in LAYOUTS.items():
        mesh = jax_mesh.make_mesh(n, model_parallel=mp)
        jfields = dict(fields, nce_impl="xla")
        tcfg = JaxTrainConfig(batch_size=B, lr=LR, wd=WD, donate=False,
                              **jfields)
        tx = jax_optim.pretrain_optimizer(jparams, LR, WD)
        state = jax_step.TrainState(jparams, tx.init(jparams),
                                    jnp.zeros((), jnp.int32))
        xb = jax_mesh.shard_batch(mesh, jnp.asarray(x))
        state, m = jax_step.make_pretrain_step(jcfg, tcfg, mesh, tx)(
            state, xb, jax.random.PRNGKey(1))
        out[name] = ({k: float(v) for k, v in m.items()},
                     dpc_state_dict_from_jax(
                         jax.tree.map(np.asarray, state.params)))
        if name == "data2_model2":
            ev = jax_step.make_eval_step(jcfg, tcfg, mesh)
            out["eval"] = {k: float(v) for k, v in
                           ev(jparams, xb, jax.random.PRNGKey(1)).items()}
    return out


def _jax_nce(inp) -> dict:
    mesh = jax_mesh.make_mesh(4, model_parallel=2)
    out = {}
    for impl in ("xla", "fused"):
        def body(pred, gt, impl=impl):
            def loss(pr, g):
                return jax_sharded_nce.sharded_nce_loss(pr, g, impl=impl)
            (l, met), grads = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(pred, gt)
            return l, met, grads[0], grads[1]

        l, met, dp, dg = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P(), P(), P(("data", "model")), P(("data", "model"))),
            check_vma=False))(jnp.asarray(inp["pred"]),
                              jnp.asarray(inp["gt"]))
        out[impl] = {"loss": float(l),
                     "metrics": {k: float(v) for k, v in met.items()},
                     "dpred": np.asarray(dp), "dgt": np.asarray(dg)}
    return out


def _jax_bn(inp) -> dict:
    mesh = jax_mesh.make_mesh(4)
    params = {"scale": jnp.asarray(inp["bn_w"]),
              "bias": jnp.asarray(inp["bn_b"])}

    def body(x, p, ct):
        def f(x, p):
            y, _ = jax_layers.batchnorm(p, None, x, train=True,
                                        axis_name="data")
            return jnp.sum(y * ct), y
        (_, y), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(x, p)
        return y, dx, dp["scale"][None], dp["bias"][None]

    y, dx, dw, db = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("data"), P(), P("data")),
        out_specs=(P("data"),) * 4, check_vma=False))(
        jnp.asarray(inp["bn_x"]), params, jnp.asarray(inp["bn_ct"]))
    return {"y": np.asarray(y), "dx": np.asarray(dx),
            "dw": np.asarray(dw), "db": np.asarray(db)}


def _jax_finetune(lparams, lstate, inp) -> dict:
    """dpc_tpu's finetune step on each LC layout's virtual mesh, and its
    eval step on the model-axis one."""
    jcfg = JaxDPCConfig(**SHAPE)
    ecfg = JaxEvalConfig(num_classes=CLASSES, dropout=0.0, batch_size=B,
                         lr=LR, wd=FT_WD)
    out = {}
    for name, (n, mp) in FT_LAYOUTS.items():
        mesh = jax_mesh.make_mesh(n, model_parallel=mp)
        xb = jax_mesh.shard_batch(mesh, jnp.asarray(inp["lc_x"]))
        yb = jax_mesh.shard_batch(mesh, jnp.asarray(inp["lc_y"], jnp.int32))
        tx = jax_optim.finetune_optimizer(lparams, LR, FT_WD, "ft", 0.1)
        state = jax_ft.FinetuneState(lparams, lstate, tx.init(lparams),
                                     jnp.zeros((), jnp.int32))
        state, m = jax_ft.make_finetune_step(jcfg, ecfg, mesh, tx,
                                             donate=False)(
            state, xb, yb, jax.random.PRNGKey(1), jnp.float32(1.0))
        out[name] = ({k: float(v) for k, v in m.items()},
                     lc_state_dict_from_jax(
                         jax.tree.map(np.asarray, state.params),
                         jax.tree.map(np.asarray, state.state)))
        if mp == 2:
            ev = jax_ft.make_finetune_eval_step(jcfg, ecfg, mesh)
            out["ft_eval"] = {k: float(v) for k, v in ev(
                lparams, lstate, xb, yb, jax.random.PRNGKey(1)).items()}
    return out


def _jax_test(lparams, lstate, tmp: str) -> dict:
    """dpc_tpu's ``run_test`` on one device with the same weights; its
    confusion matrix is taken where it would be plotted."""
    cfg = jax_evaluate.config_from_args(jax_evaluate.build_parser(
        ).parse_args(TEST_ARGS))
    mats = []

    class Recorded(jax_evaluate.ConfusionMeter):
        def plot_mat(self, path, *args, **kwargs):
            mats.append(self.mat.copy())

    exp_dir = os.path.join(tmp, "jax_test")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_evaluate, "ConfusionMeter", Recorded)
        loss, top1 = jax_evaluate.run_test(cfg, lparams, lstate, exp_dir,
                                           window_batch=8)
    return {"loss": loss, "top1": top1, **_read_test(exp_dir),
            "confusion": mats[0]}


def _jax_stem(inp) -> dict:
    """dpc_tpu's ``fused_stem`` with ``axis_name`` over 2 devices: outputs,
    the per-device gradients, and its LC train mode's running
    statistics."""
    mesh = jax_mesh.make_mesh(2)
    conv = {"w": jnp.asarray(inp["stem_w"])}
    bn = {"scale": jnp.asarray(inp["stem_gamma"]),
          "bias": jnp.asarray(inp["stem_beta"])}
    state = {"mean": jnp.asarray(inp["stem_mean"]),
             "var": jnp.asarray(inp["stem_var"])}

    def body(x, cp, bp, ct):
        def f(x, cp, bp):
            y, _ = jax_layers.fused_stem(cp, bp, x, axis_name="data")
            return jnp.sum(y * ct), y
        (_, y), (dx, dc, db) = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(x, cp, bp)
        _, new = jax_layers.fused_stem(cp, bp, x, state=state, train=True,
                                       axis_name="data")
        return (y, dx, dc["w"][None], db["scale"][None], db["bias"][None],
                new["mean"], new["var"])

    y, dx, dw, dg, dbeta, mean, var = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("data"), P(), P(), P("data")),
        out_specs=(P("data"),) * 5 + (P(), P()), check_vma=False))(
        jnp.asarray(inp["stem_x"]), conv, bn, jnp.asarray(inp["stem_ct"]))
    return {"y": np.asarray(y), "dx": np.asarray(dx), "dw": np.asarray(dw),
            "dgamma": np.asarray(dg), "dbeta": np.asarray(dbeta),
            "running": (np.asarray(mean), np.asarray(var))}


def _jax_bn2d(inp) -> dict:
    """dpc_tpu's ``layers.batchnorm`` with ``axis_name`` and running
    statistics on a 2-D input over 4 devices: outputs, gradients and the
    updated statistics."""
    mesh = jax_mesh.make_mesh(4)
    d = BN2_SHAPE[-1]
    params = {"scale": jnp.asarray(inp["bn2_w"]),
              "bias": jnp.asarray(inp["bn2_b"])}
    state = {"mean": jnp.zeros(d), "var": jnp.ones(d)}

    def body(x, p, ct):
        def f(x, p):
            y, new = jax_layers.batchnorm(p, state, x, train=True,
                                          axis_name="data")
            return jnp.sum(y * ct), (y, new)
        (_, (y, new)), (dx, dp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(x, p)
        return (y, dx, dp["scale"][None], dp["bias"][None], new["mean"],
                new["var"])

    y, dx, dw, db, mean, var = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("data"), P(), P("data")),
        out_specs=(P("data"),) * 4 + (P(), P()), check_vma=False))(
        jnp.asarray(inp["bn2_x"]), params, jnp.asarray(inp["bn2_ct"]))
    return {"y": np.asarray(y), "dx": np.asarray(dx), "dw": np.asarray(dw),
            "db": np.asarray(db), "running": (np.asarray(mean),
                                              np.asarray(var))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every comparison: the port's two rank jobs run in
    background threads while dpc_tpu compiles and runs its programs."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    inp = _inputs()
    port, errors = {}, []

    def job(world):
        try:
            port[world] = meshlib.run_ranks(_port_job, world, (tmp, inp))
        except Exception as e:  # reported by the fixture below
            errors.append(e)

    threads = [threading.Thread(target=job, args=(w,)) for w in (4, 2)]
    for t in threads:
        t.start()
    try:
        jparams = jax_dpc.init_dpc(jax.random.PRNGKey(0),
                                   JaxDPCConfig(**SHAPE))
        before = dpc_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
        torch.save(before, os.path.join(tmp, "weights.pt"))
        lparams, lstate = jax_lc.init_lc(jax.random.PRNGKey(2),
                                         JaxDPCConfig(**SHAPE), CLASSES)
        lc_before = lc_state_dict_from_jax(
            jax.tree.map(np.asarray, lparams),
            jax.tree.map(np.asarray, lstate))
        torch.save(lc_before, os.path.join(tmp, "lc_weights.pt"))
    finally:
        Path(tmp, "ready").touch()  # the ranks wait for the weights
    ref = {"steps": _jax_steps(jparams, inp["x"]), "nce": _jax_nce(inp),
           "bn": _jax_bn(inp), "ft": _jax_finetune(lparams, lstate, inp),
           "test": _jax_test(lparams, lstate, tmp), "bn2d": _jax_bn2d(inp),
           "stem": _jax_stem(inp)}
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "a rank job did not finish"
    if errors:
        raise errors[0]
    params = {name: torch.load(os.path.join(tmp, f"{name}.pt"),
                               weights_only=True)
              for name in [*LAYOUTS, *FT_LAYOUTS]}
    return {"port": port, "ref": ref, "inp": inp, "before": before,
            "lc_before": lc_before, "params": params, "tmp": tmp}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_params_close(got: dict, want: dict, before: dict) -> None:
    """Updated parameters: every one within the 2·lr an Adam step costs
    where its gradient's sign flips; the two updates' cosine at least
    0.99; and 99.5% of them within 1e-4 of the largest parameter."""
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    close = total = 0
    dot = n_got = n_want = 0.0
    for k, w in want.items():
        g = torch.as_tensor(got[k]).double() - before[k].double()
        w = torch.as_tensor(w).double() - before[k].double()
        diff = (g - w).abs()
        assert float(diff.max()) <= 2.05 * LR, k
        close += int((diff <= 1e-4 * scale).sum())
        total += diff.numel()
        dot += float((g * w).sum())
        n_got += float((g * g).sum())
        n_want += float((w * w).sum())
    assert dot / math.sqrt(n_got * n_want) >= 0.99
    assert close >= 0.995 * total, (close, total)


# ---------------------------------------------------------------------------
# (a) K7's plain version against nce_pallas.nce_lse_rank_shard
# ---------------------------------------------------------------------------

def test_k7_plain_matches_pallas_shard_kernel():
    rng = np.random.default_rng(1)
    r, c, d = 40, 56, 24
    rows = rng.normal(size=(r, d)).astype(np.float32) * 0.5
    cols = rng.normal(size=(c, d)).astype(np.float32) * 0.5
    targets = rng.integers(0, c, size=r).astype(np.int32)
    targets[::2] = -1                      # off the owner: half the rows
    pos = (rows * cols[np.maximum(targets, 0)]).sum(-1).astype(np.float32)
    g = rng.normal(size=r).astype(np.float32)

    (lse_j, rank_j), vjp = jax.vjp(
        lambda a, b, p: nce_pallas.nce_lse_rank_shard(
            a, b, p, jnp.asarray(targets)),
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(pos))
    dr_j, dc_j, dp_j = vjp((jnp.asarray(g), jnp.zeros_like(rank_j)))

    for fn in (nce_cuda.nce_lse_rank_shard, nce_cuda.nce_lse_rank_shard_plain):
        a = torch.tensor(rows, requires_grad=True)
        b = torch.tensor(cols, requires_grad=True)
        p = torch.tensor(pos, requires_grad=True)
        lse, rank = fn(a, b, p, torch.from_numpy(targets))
        (lse * torch.from_numpy(g)).sum().backward()
        assert _rel(lse.detach(), lse_j) <= 1e-5
        np.testing.assert_array_equal(rank.numpy(), np.asarray(rank_j))
        assert _rel(a.grad, dr_j) <= 1e-5
        assert _rel(b.grad, dc_j) <= 1e-5
        assert float(p.grad.abs().max()) == 0.0 == float(np.abs(dp_j).max())


# ---------------------------------------------------------------------------
# (b) the candidate-sharded loss, (c) group BN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_sharded_nce_loss_matches_shard_map(runs, impl):
    want = runs["ref"]["nce"][impl]
    rank_b = NCE_SHAPE[0] // 2  # each peer holds its data group's clips
    for r, res in enumerate(runs["port"][4]):
        got = res["nce"][impl]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["metrics"] == want["metrics"]
        rows = slice(r * rank_b, (r + 1) * rank_b)
        assert _rel(got["dpred"], want["dpred"][rows]) <= 1e-4
        assert _rel(got["dgt"], want["dgt"][rows]) <= 1e-4


def test_group_batchnorm_matches_cross_replica_bn(runs):
    want = runs["ref"]["bn"]
    per = BN_SHAPE[0] // 4
    for r, res in enumerate(runs["port"][4]):
        got = res["bn"]
        rows = slice(r * per, (r + 1) * per)
        assert _rel(got["y"], want["y"][rows]) <= 1e-5
        assert _rel(got["dx"], want["dx"][rows]) <= 1e-5
        assert _rel(got["dw"], want["dw"][r]) <= 1e-5
        assert _rel(got["db"], want["db"][r]) <= 1e-5


def test_group_batchnorm_running_stats_use_the_global_count(runs):
    """The running statistics of a group BN in train mode equal those of
    one BN over the whole batch: the unbiased variance takes the global
    element count (``test_train_step.py``'s EMA pin, here against
    torch's own BN on the full batch)."""
    full = layers.batchnorm3d(BN_SHAPE[-1], track_running_stats=True)
    full(torch.from_numpy(runs["inp"]["bn_x"]).permute(0, 4, 1, 2, 3))
    for res in runs["port"][4]:
        mean, var = res["bn"]["running"]
        assert _rel(mean, full.running_mean) <= 1e-5
        assert _rel(var, full.running_var) <= 1e-5


# ---------------------------------------------------------------------------
# (d) the train steps, (e) the eval step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(LAYOUTS))
def test_train_step_matches_dpc_tpu(runs, name):
    world = LAYOUTS[name][0]
    want_m, want_p = runs["ref"]["steps"][name]
    results = [res[name] for res in runs["port"][world]]
    for res in results:
        for k, v in want_m.items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-4,
                                       err_msg=k)
    # the same Adam update on every rank: bit-identical parameters
    assert len({res["digest"] for res in results}) == 1
    _assert_params_close(runs["params"][name], want_p, runs["before"])


def test_model_axis_equals_data_only_layout(runs):
    """{data:2, model:2} computes what {data:2} computes (the port's own
    pin of dpc_tpu's ``{d,m} ≡ {d}``): loss and top-k, the Adam update,
    and the SGD update's norm (a miscounted m-factor scales it by m)."""
    mp = runs["port"][4][0]["data2_model2"]["metrics"]
    dp = runs["port"][2][0]["data2_global"]["metrics"]
    for k in dp:
        np.testing.assert_allclose(mp[k], dp[k], rtol=1e-4, err_msg=k)
    _assert_params_close(runs["params"]["data2_model2"],
                         runs["params"]["data2_global"], runs["before"])
    ratio = (runs["port"][4][0]["data2_model2"]["norm"]
             / runs["port"][2][0]["data2_global"]["norm"])
    assert abs(ratio - 1.0) <= 1e-3, ratio


def test_eval_step_matches_dpc_tpu(runs):
    want = runs["ref"]["steps"]["eval"]
    for res in runs["port"][4]:
        for k, v in want.items():
            np.testing.assert_allclose(res["eval"][k], v, rtol=1e-4,
                                       err_msg=k)


def test_dryrun_body_takes_one_finite_step(runs):
    """``dryrun_multichip(4)``'s rank body on the module's 4 ranks: uint8
    windows through the sized-crop recipe, {data:2, model:2}, global
    negatives; a finite loss, one Adam step, the same parameters on every
    rank."""
    results = [res["dryrun"] for res in runs["port"][4]]
    assert results[0]["shape"] == {"data": 2, "model": 2}
    assert all(math.isfinite(r["loss"]) and r["steps"] == [1]
               for r in results)
    assert len({r["digest"] for r in results}) == 1


# ---------------------------------------------------------------------------
# (i) the LC path: the finetune and eval steps, the 2-D group BN, the dense
# test across ranks
# ---------------------------------------------------------------------------

def _split_lc(sd: dict) -> tuple[dict, dict]:
    """(parameters, running statistics) of an LC state_dict."""
    stats = {k: v for k, v in sd.items() if "running" in k}
    return ({k: v for k, v in sd.items()
             if k not in stats and "num_batches" not in k}, stats)


def _assert_stats_close(got: dict, want: dict) -> None:
    for k, w in want.items():
        assert _rel(got[k], w) <= 1e-5, k


@pytest.mark.parametrize("name", list(FT_LAYOUTS))
def test_finetune_step_matches_dpc_tpu(runs, name):
    world = FT_LAYOUTS[name][0]
    want_m, want_sd = runs["ref"]["ft"][name]
    results = [res[name] for res in runs["port"][world]]
    for res in results:
        for k, v in want_m.items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-4,
                                       err_msg=k)
    # the same update and the same running statistics on every rank
    assert len({res["digest"] for res in results}) == 1
    got_p, got_s = _split_lc(runs["params"][name])
    want_p, want_s = _split_lc(want_sd)
    _assert_params_close(got_p, want_p, runs["lc_before"])
    _assert_stats_close(got_s, want_s)


def test_finetune_model_axis_equals_data_only_layout(runs):
    """{data:2, model:2} computes what {data:2} computes: loss and top-k,
    the Adam update, the running statistics (BN over the model group,
    then averaged over every rank), and the SGD update's norm (a psum
    where the mean belongs would scale it)."""
    mp = runs["port"][4][0]["ft_data2_model2"]["metrics"]
    dp = runs["port"][2][0]["ft_data2"]["metrics"]
    for k in dp:
        np.testing.assert_allclose(mp[k], dp[k], rtol=1e-4, err_msg=k)
    mp_p, mp_s = _split_lc(runs["params"]["ft_data2_model2"])
    dp_p, dp_s = _split_lc(runs["params"]["ft_data2"])
    _assert_params_close(mp_p, dp_p, runs["lc_before"])
    _assert_stats_close(mp_s, dp_s)
    ratio = (runs["port"][4][0]["ft_data2_model2"]["norm"]
             / runs["port"][2][0]["ft_data2"]["norm"])
    assert abs(ratio - 1.0) <= 1e-3, ratio


def test_finetune_eval_step_matches_dpc_tpu(runs):
    want = runs["ref"]["ft"]["ft_eval"]
    for res in runs["port"][4]:
        for k, v in want.items():
            np.testing.assert_allclose(res["ft_eval"][k], v, rtol=1e-4,
                                       err_msg=k)


def test_group_batchnorm_2d_matches_dpc_tpu(runs):
    """The LC head's ``final_bn`` over a group: ``[B, D]`` features, batch
    statistics over 4 ranks, outputs, gradients and the running
    statistics' update against ``dpc_tpu``'s ``batchnorm(axis_name=)``."""
    want = runs["ref"]["bn2d"]
    per = BN2_SHAPE[0] // 4
    for r, res in enumerate(runs["port"][4]):
        got = res["bn2d"]
        rows = slice(r * per, (r + 1) * per)
        assert _rel(got["y"], want["y"][rows]) <= 1e-5
        assert _rel(got["dx"], want["dx"][rows]) <= 1e-5
        assert _rel(got["dw"], want["dw"][r]) <= 1e-5
        assert _rel(got["db"], want["db"][r]) <= 1e-5
        for g, w in zip(got["running"], want["running"]):
            assert _rel(g, w) <= 1e-5


def test_fused_stem_over_the_group_matches_dpc_tpu(runs):
    """``layers.fused_stem`` with its statistics over the 2-rank group
    (the ``bn_group`` of a cross-replica step) against ``dpc_tpu``'s
    ``fused_stem(axis_name="data")`` under ``shard_map``: outputs, the
    gradients of x, the conv weight, γ (its γ = 0 channel included) and
    β on each rank, and the EMA of its LC train mode over the global
    count."""
    want = runs["ref"]["stem"]
    per = STEM_X[0] // 2
    for r, res in enumerate(runs["port"][2]):
        got = res["stem"]
        rows = slice(r * per, (r + 1) * per)
        assert _rel(got["y"], want["y"][rows]) <= 1e-5
        assert _rel(got["dx"], want["dx"][rows]) <= 2e-4
        for k in ("dw", "dgamma", "dbeta"):
            assert _rel(got[k], want[k][r]) <= 2e-4, k
        assert abs(float(got["dgamma"][1])) > 1e-3
        for g, w in zip(got["running"], want["running"]):
            assert _rel(g, w) <= 1e-5


def test_dense_test_on_two_ranks_matches_one_rank_and_dpc_tpu(runs):
    """``run_test`` splits the 5 videos over 2 ranks (3 and 2) and sums
    their results on the host group: the same loss, top-1, top-5 and
    confusion matrix as one rank and as ``dpc_tpu``'s ``run_test`` on one
    device; every rank returns the summed result."""
    want = runs["ref"]["test"]
    two = [res["test"][2] for res in runs["port"][2]]
    one = runs["port"][2][0]["test"][1]
    assert two[0]["loss"] == two[1]["loss"] and two[0]["top1"] == two[1][
        "top1"]
    for got in (two[0], one):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
        np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert int(want["confusion"].sum()) == 5


def test_dryrun_body_runs_the_finetune_half(runs):
    """``dryrun_multichip(4)``'s finetune half on the module's 4 ranks:
    one clip-sharded LC step with the device recipe (finite loss, one
    Adam step, the same parameters and running statistics on every rank)
    and the dense-test forward's ``[2·4, classes]`` finite logits."""
    results = [res["dryrun"] for res in runs["port"][4]]
    assert all(math.isfinite(r["ft_loss"]) and r["ft_steps"] == [1]
               for r in results)
    assert len({r["ft_digest"] for r in results}) == 1
    assert all(r["test_logits"] == (8, dryrun.CLASSES) and r["test_finite"]
               for r in results)


# ---------------------------------------------------------------------------
# (f) the guards
# ---------------------------------------------------------------------------

def test_layout_guards():
    model = dpc.DPC(DPCConfig(**SHAPE))
    opt = optim.pretrain_optimizer(model, LR, WD)
    mesh = meshlib.Mesh(4, 2, 0)   # {data:4, model:2}, no groups
    cfg = DPCConfig(**SHAPE)
    local = TrainConfig(batch_size=B, negatives="local", model_parallel=2)
    with pytest.raises(ValueError, match="negatives global"):
        pretrain_step.make_pretrain_step(cfg, local, model, opt, mesh)
    with pytest.raises(ValueError, match="negatives global"):
        pretrain_step.make_eval_step(cfg, local, model, mesh)
    odd = TrainConfig(batch_size=12, negatives="global", model_parallel=2)
    with pytest.raises(ValueError, match="not divisible"):
        pretrain_step.make_pretrain_step(cfg, odd, model, opt, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        pretrain_step.make_eval_step(cfg, odd, model, mesh)
    with pytest.raises(ValueError, match="needs a mesh"):
        pretrain_step.make_pretrain_step(
            cfg, TrainConfig(batch_size=B, model_parallel=2), model, opt)


def test_cli_refuses_bad_layouts_before_starting_ranks(monkeypatch):
    base = ["--dataset", "synthetic", "--batch_size", "8"]
    with pytest.raises(SystemExit, match="negatives global"):
        pretrain.main(base + ["--device", "cpu", "--num_devices", "4",
                              "--model_parallel", "2"])
    with pytest.raises(SystemExit, match="divisible by 3 devices"):
        pretrain.main(base + ["--device", "cpu", "--num_devices", "3"])
    # one card: two ranks are refused, not put on the one card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 2 cards"):
        pretrain.main(base + ["--num_devices", "2"])


CPU = ["--device", "cpu"]


@pytest.mark.parametrize("case", [
    (CPU + ["--num_devices", "3"], "8 must be divisible by 3 devices"),
    (CPU + ["--num_devices", "3", "--test", "random", "--batch_size", "4"],
     "4 must be divisible by 3 devices"),
    (CPU + ["--num_devices", "16"], "8 must be divisible by 16 devices"),
    (CPU + ["--multihost", "--device_augment", "--num_devices", "3"],
     "8 must be divisible by 3 devices"),
    (CPU + ["--multihost", "--num_devices", "2", "--batch_size", "3"],
     "3 must be divisible by 2 devices"),
    (CPU + ["--num_devices", "3", "--model_parallel", "2", "--batch_size",
            "6"], "3 devices not divisible by --model_parallel 2"),
    (CPU + ["--model_parallel", "2"],
     "1 devices not divisible by --model_parallel 2"),
    (CPU + ["--model_parallel", "4", "--test", "random"],
     "1 devices not divisible by --model_parallel 4"),
    (CPU + ["--model_parallel", "2", "--five_crop"],
     "1 devices not divisible by --model_parallel 2"),
    (CPU + ["--multihost", "--model_parallel", "2", "--test", "random"],
     "1 devices not divisible by --model_parallel 2"),
    (["--num_devices", "2"], "needs 2 cards"),
    (["--num_devices", "4", "--model_parallel", "2"], "needs 4 cards")],
    ids=["batch", "batch-test", "batch-16", "batch-multihost-augment",
         "batch-multihost", "model", "model-one-rank", "model4-test",
         "model-five-crop", "model-multihost", "cards", "cards-model"])
def test_finetune_cli_refuses_bad_layouts_before_starting_ranks(
        monkeypatch, case):
    """The finetune CLI refuses a batch the ranks do not divide, ranks the
    model axis does not divide (on one rank too, with or without the
    dense test, the five crops or ``--multihost``), and more ranks than
    cards (one card here), each before it starts a rank."""
    argv, reason = case

    def no_ranks(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(meshlib, "run_ranks", no_ranks)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=reason):
        evaluate.main(["--dataset", "synthetic", "--batch_size", "8",
                       *argv])


def test_seed_streams_follow_the_layout():
    """Data shards draw distinct streams, model peers share the
    augmentation stream and take their slice of the data group's draws,
    and their dropout streams differ; one data shard changes nothing."""
    grid = [meshlib.Mesh(2, 2, r) for r in range(4)]
    data = [meshlib.data_seed(m, 7) for m in grid]
    assert data[0] == data[1] != data[2] == data[3]
    assert len({meshlib.dropout_seed(m, 7) for m in grid}) == 4
    assert [meshlib.peer_rows(m, 3) for m in grid] == [(6, 0), (6, 3)] * 2
    one = meshlib.Mesh(1, 1, 0)
    assert meshlib.data_seed(one, 7) == meshlib.dropout_seed(one, 7) == 7
    assert meshlib.shard_batch(grid[2], np.arange(8)).tolist() == [4, 5]


# ---------------------------------------------------------------------------
# (g) the CLI on two CPU ranks, (h) a signal to one rank
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--dataset", "synthetic", "--img_dim", "32",
       "--num_seq", "3", "--seq_len", "4", "--pred_step", "1",
       "--batch_size", "4", "--synthetic_videos", "8", "--num_workers", "1",
       "--compute_dtype", "float32", "--print_freq", "1"]


def _cli(*args) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE")}
    proc = subprocess.run(
        [sys.executable, "-m", "dpc_tpu_torch.train.pretrain", *CLI, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_cli_two_ranks_trains_checkpoints_and_resumes(tmp_path):
    out = _cli("--num_devices", "2", "--negatives", "global",
               "--nce_impl", "fused", "--steps_per_epoch", "2", "--epochs",
               "1", "--log_dir", str(tmp_path))
    assert "devices: {'data': 2, 'model': 1} × cpu" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("epoch 0: train")]
    assert len(lines) == 1, out        # rank 0 alone prints
    loss = float(lines[0].split("loss")[1].split()[0])
    assert math.isfinite(loss)
    run = next(tmp_path.glob("*/model"))
    assert sorted(p.name for p in run.iterdir()) == [
        "epoch1.pth.tar", "model_best_epoch1.pth.tar"]
    out = _cli("--num_devices", "2", "--negatives", "global",
               "--nce_impl", "fused", "--steps_per_epoch", "2", "--epochs",
               "2", "--resume", str(run.parent))
    assert out.count("resumed epoch 1") == 1, out
    assert [ln for ln in out.splitlines() if ln.startswith("epoch ")] \
        == [ln for ln in out.splitlines() if ln.startswith("epoch 1: train")]
    assert (run / "epoch2.pth.tar").exists()


def _preempted_rank(rank: int, argv: list, main=pretrain.main) -> dict:
    """Run a CLI's ``main`` as one rank; rank 1 sends itself SIGTERM as
    train step 1 is seeded.  Returns the train steps this rank seeded,
    the step positions it computed a checkpoint name for (rank 0 alone
    does in the finetune CLI) and its exit message."""
    from dpc_tpu_torch.core import checkpoint as ck
    from dpc_tpu_torch.train import loop

    saved, seeded = [], set()
    step_id, step_seed = ck.mid_epoch_step_id, loop.step_seed

    def spy_id(epoch, batch_idx, offset=0):
        saved.append((epoch, batch_idx))
        return step_id(epoch, batch_idx, offset)

    def seed(s, epoch, idx, *stream):
        if not stream:
            seeded.add((epoch, idx))
        if rank == 1 and idx == 1 and not stream:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_seed(s, epoch, idx, *stream)

    ck.mid_epoch_step_id, loop.step_seed = spy_id, seed
    out = {"saved": saved, "seeded": seeded, "exit": ""}
    try:
        main(argv)
    except SystemExit as e:
        out["exit"] = str(e.code)
    finally:
        ck.mid_epoch_step_id, loop.step_seed = step_id, step_seed
    return out


def test_signal_to_one_rank_checkpoints_every_rank_at_one_step(tmp_path):
    argv = CLI + ["--num_devices", "2", "--steps_per_epoch", "4",
                  "--epochs", "1", "--save_every_steps", "100",
                  "--log_dir", str(tmp_path)]
    results = meshlib.run_ranks(_preempted_rank, 2, (argv,))
    assert [r["seeded"] for r in results] == [{(0, 0), (0, 1)}] * 2, results
    assert [r["saved"] for r in results] == [[(0, 1)], [(0, 1)]], results
    assert all(r["exit"].startswith("[preemption]") for r in results)
    (step_file,) = tmp_path.glob("*/model_steps/step*.pth.tar")
    payload = torch.load(step_file, weights_only=True)
    assert (payload["epoch"], payload["batch_idx"]) == (0, 1)


def test_signal_to_one_finetune_rank_checkpoints_every_rank_at_one_step(
        runs):
    """The finetune CLI in the 2-rank job: rank 1 alone is signalled at
    train step 1, and both ranks stop after that step, rank 0 writing the
    one step checkpoint."""
    results = [res["preempted"] for res in runs["port"][2]]
    assert [r["seeded"] for r in results] == [{(0, 0), (0, 1)}] * 2, results
    assert [r["saved"] for r in results] == [[(0, 1)], []], results
    assert all(r["exit"].startswith("[preemption]") for r in results)
    tmp = Path(runs["tmp"], "cli_p")
    (step_file,) = tmp.glob("*/model_steps/step*.pth.tar")
    payload = torch.load(step_file, weights_only=True)
    assert (payload["epoch"], payload["batch_idx"]) == (0, 1)


# ---------------------------------------------------------------------------
# (j) the finetune CLI on the module's two CPU ranks: train, resume, test
# ---------------------------------------------------------------------------

def test_finetune_cli_two_ranks_trains_resumes_and_tests(runs):
    """The finetune CLI run by the 2-rank job as torchrun's ranks run it:
    one epoch with its checkpoint, rank 0 alone printing and writing; the
    resume into a second epoch; ``--test`` of the run on both ranks, the
    videos split between them (``_finetune_cli``)."""
    cli = [res["cli"] for res in runs["port"][2]]
    # rank 0 alone prints
    assert not any(cli[1][k] for k in ("train", "resume", "test"))
    out = cli[0]
    assert "devices: {'data': 2, 'model': 1}" in out["train"]
    lines = [ln for ln in out["train"].splitlines()
             if ln.startswith("[epoch 0] 2 ")]
    assert len(lines) == 1 and "val loss" in lines[0], out["train"]
    assert "resumed epoch 1" in out["resume"]
    resumed = out["resume"].splitlines()
    assert [ln for ln in resumed if ln.startswith("epoch ")] \
        == [ln for ln in resumed if ln.startswith("epoch 1: train")]
    run = Path(out["run"])
    # the manager keeps the newest epoch and the best one
    saved = sorted(p.name for p in (run / "model").iterdir())
    assert saved[0] == "epoch2.pth.tar" and len(saved) == 2, saved
    assert saved[1] in ("model_best_epoch1.pth.tar",
                        "model_best_epoch2.pth.tar"), saved
    assert (run / "train_log.md").read_text().count("val top1") == 2
    test = out["test"]
    assert "loaded test checkpoint" in test
    assert "95 windows / 5 videos" in test and "over 2 ranks" in test
    loss = float(test.split("[test] loss ")[1].split(";")[0])
    assert math.isfinite(loss)
    (log,) = Path(out["test_dir"]).glob("*/test_log.md")
    assert f"loss: {loss:.4f}" in log.read_text()
    mat = np.loadtxt(log.parent / "confusion_matrix.txt", dtype=np.int64)
    assert mat.shape == (8, 8) and int(mat.sum()) == 5
