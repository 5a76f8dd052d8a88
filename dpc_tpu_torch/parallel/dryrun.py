"""A dry run of the whole multi-rank pretrain and finetune path on CPU
ranks (the port's counterpart of ``dpc_tpu``'s ``dryrun_multichip``,
``__graft_entry__.py:38-166``).

``dryrun_multichip(n)`` starts ``n`` gloo ranks on the CPU and runs, at a
tiny size, with a model axis of 2 when ``n`` is even and at least 4:

  * one pretrain train step of the production path: uint8 windows
    through ``--device_augment``'s ``sized_crop`` recipe inside the step,
    global negatives gathered over the data group (the candidate-sharded
    NCE on the model axis), the gradients averaged over the ranks and the
    Adam update;
  * on the same ranks, one clip-sharded LC finetune step with the
    finetune recipe on the device, BN statistics over the model group,
    gradients, metrics and running statistics averaged over the ranks;
  * the dense-test forward of ``2·n`` windows, each rank its ``2`` rows.

It checks finite losses, one optimizer step taken by each, the same
parameters (and running statistics) on every rank, and the test logits'
shape ``[2·n, classes]`` and finiteness.

    python -c "from dpc_tpu_torch.parallel.dryrun import dryrun_multichip as d; d(4)"
"""

from __future__ import annotations

import hashlib

import torch

from dpc_tpu_torch.core.config import DPCConfig, EvalConfig, TrainConfig
from dpc_tpu_torch.models import dpc, lc
from dpc_tpu_torch.parallel import collectives
from dpc_tpu_torch.parallel import mesh as meshlib
from dpc_tpu_torch.train import finetune_step, optim, pretrain_step

CFG = DPCConfig(img_dim=32, num_seq=3, seq_len=4, pred_step=1,
                compute_dtype="float32")


CLASSES = 11


def param_digest(model: torch.nn.Module) -> str:
    """A digest of every parameter's and buffer's bytes: equal across
    ranks exactly when they are bit-identical."""
    h = hashlib.sha256()
    for p in [*model.parameters(), *model.buffers()]:
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _dryrun_rank(rank: int, mp: int, batch: int) -> dict:
    mesh = meshlib.make_mesh(0, model_parallel=mp)
    tcfg = TrainConfig(batch_size=batch, lr=1e-3, wd=1e-5,
                       negatives="global", model_parallel=mp,
                       device_augment=True,
                       device_augment_recipe="sized_crop")
    dev = torch.device("cpu")
    model = dpc.build_dpc(CFG, dev, seed=0)
    opt = optim.pretrain_optimizer(model, tcfg.lr, tcfg.wd)
    step = pretrain_step.make_pretrain_step(CFG, tcfg, model, opt, mesh)
    x = torch.randint(0, 256, (batch, CFG.num_seq, CFG.seq_len,
                               CFG.img_dim + 8, CFG.img_dim + 8, 3),
                      generator=torch.Generator().manual_seed(1),
                      dtype=torch.uint8)
    gen = torch.Generator().manual_seed(meshlib.dropout_seed(mesh, 2))
    aug = torch.Generator().manual_seed(meshlib.data_seed(mesh, 3))
    metrics = step(meshlib.shard_batch(mesh, x), gen, aug)
    steps = {int(s["step"]) for s in opt.state.values()}
    out = {"loss": float(metrics["loss"]), "shape": mesh.shape,
           "steps": sorted(steps), "digest": param_digest(model)}
    return {**out, **_finetune_rank(mesh, x, batch)}


def _finetune_rank(mesh: meshlib.Mesh, x: torch.Tensor, batch: int) -> dict:
    """The finetune half on this rank: one clip-sharded LC step on the
    pretrain step's uint8 windows with the finetune recipe on the device,
    then the dense-test forward of this rank's 2 of ``2·ranks`` windows,
    whose logits are gathered over the ranks."""
    ecfg = EvalConfig(num_classes=CLASSES, dropout=0.5, batch_size=batch,
                      device_augment=True)
    dev = torch.device("cpu")
    model = lc.build_lc(CFG, CLASSES, dev, dropout=ecfg.dropout, seed=3)
    opt = optim.finetune_optimizer(model, ecfg.lr, ecfg.wd, ecfg.train_what,
                                   ecfg.backbone_lr_scale)
    step = finetune_step.make_finetune_step(CFG, ecfg, model, opt, mesh)
    y = torch.arange(batch) % CLASSES
    gen = torch.Generator().manual_seed(meshlib.dropout_seed(mesh, 4))
    aug = torch.Generator().manual_seed(meshlib.data_seed(mesh, 4))
    metrics = step(meshlib.shard_batch(mesh, x),
                   meshlib.shard_batch(mesh, y), gen, 1.0, aug)
    steps = {int(s["step"]) for s in opt.state.values()}
    win = torch.randint(0, 256, (2 * mesh.size, *x.shape[1:]),
                        generator=torch.Generator().manual_seed(5),
                        dtype=torch.uint8)
    forward = finetune_step.make_test_forward(CFG, ecfg, model,
                                              test_crop=CFG.img_dim)
    logits = collectives.gather(forward(meshlib.shard_batch(mesh, win)),
                                mesh.world_group)
    return {"ft_loss": float(metrics["loss"]), "ft_steps": sorted(steps),
            "ft_digest": param_digest(model),
            "test_logits": tuple(logits.shape),
            "test_finite": bool(torch.isfinite(logits).all())}


def dryrun_multichip(n_devices: int) -> dict:
    """Run the pretrain step, the finetune step and the dense-test forward
    on ``n_devices`` CPU ranks; raise if a rank fails, a loss is not
    finite, an optimizer did not take exactly one step, the ranks'
    parameters differ, or the test logits are not ``[2·n, classes]`` and
    finite.  Returns rank 0's result."""
    mp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    batch = 2 * (n_devices // mp)
    results = meshlib.run_ranks(_dryrun_rank, n_devices, (mp, batch))
    r0 = results[0]
    if not torch.isfinite(torch.tensor(r0["loss"])):
        raise RuntimeError(f"dryrun_multichip({n_devices}): loss "
                           f"{r0['loss']}")
    if r0["steps"] != [1]:
        raise RuntimeError(f"dryrun_multichip({n_devices}): optimizer steps "
                           f"{r0['steps']}, expected [1]")
    for part, key in (("pretrain", "digest"), ("finetune", "ft_digest")):
        if len({r[key] for r in results}) != 1:
            raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks' "
                               f"{part} parameters differ")
    print(f"dryrun_multichip({n_devices}): mesh={r0['shape']} pretrain "
          f"loss={r0['loss']:.4f} OK")
    if not (torch.isfinite(torch.tensor(r0["ft_loss"]))
            and r0["ft_steps"] == [1]):
        raise RuntimeError(f"dryrun_multichip({n_devices}): finetune loss "
                           f"{r0['ft_loss']}, optimizer steps "
                           f"{r0['ft_steps']}")
    print(f"dryrun_multichip({n_devices}): mesh={r0['shape']} finetune "
          f"loss={r0['ft_loss']:.4f} OK")
    want = (2 * n_devices, CLASSES)
    if r0["test_logits"] != want or not r0["test_finite"]:
        raise RuntimeError(f"dryrun_multichip({n_devices}): dense-test "
                           f"logits {r0['test_logits']} (finite: "
                           f"{r0['test_finite']}), expected {want}")
    print(f"dryrun_multichip({n_devices}): mesh={r0['shape']} dense-test "
          f"rows={want[0]} OK")
    return r0
