"""A dry run of the whole multi-rank pretrain step on CPU ranks (the
port's counterpart of ``dpc_tpu``'s ``dryrun_multichip``,
``__graft_entry__.py:38-121``, for its pretrain half).

``dryrun_multichip(n)`` starts ``n`` gloo ranks on the CPU and runs one
train step of the production path at a tiny size: uint8 windows through
``--device_augment``'s ``sized_crop`` recipe inside the step, global
negatives gathered over the data group, the gradients averaged over the
ranks and the Adam update, with a model axis of 2 (clip-sharded, the
candidate-sharded NCE) when ``n`` is even and at least 4.  It checks a
finite loss, one optimizer step taken, and the same parameters on every
rank.

    python -c "from dpc_tpu_torch.parallel.dryrun import dryrun_multichip as d; d(4)"
"""

from __future__ import annotations

import hashlib

import torch

from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
from dpc_tpu_torch.models import dpc
from dpc_tpu_torch.parallel import mesh as meshlib
from dpc_tpu_torch.train import optim, pretrain_step

CFG = DPCConfig(img_dim=32, num_seq=3, seq_len=4, pred_step=1,
                compute_dtype="float32")


def param_digest(model: torch.nn.Module) -> str:
    """A digest of every parameter's bytes: equal across ranks exactly
    when their parameters are bit-identical."""
    h = hashlib.sha256()
    for p in model.parameters():
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
    return {"loss": float(metrics["loss"]), "shape": mesh.shape,
            "steps": sorted(steps), "digest": param_digest(model)}


def dryrun_multichip(n_devices: int) -> dict:
    """Run one pretrain step on ``n_devices`` CPU ranks; raise if a rank
    fails, the loss is not finite, the optimizer did not take exactly one
    step, or the ranks' parameters differ.  Returns rank 0's result."""
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
    if len({r["digest"] for r in results}) != 1:
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks' "
                           "parameters differ")
    print(f"dryrun_multichip({n_devices}): mesh={r0['shape']} pretrain "
          f"loss={r0['loss']:.4f} OK")
    return r0
