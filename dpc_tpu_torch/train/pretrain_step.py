"""The DPC pretraining train step on one device (port of
``dpc_tpu/train/pretrain_step.py:47-230``).

One step is forward, loss, backward and the Adam update, applied in place
to the model's parameters.  Negatives are local: the device scores its own
batch only, which is the reference's per-GPU pool (``dpc/main.py:180,212``).
Under ``compute_dtype="bfloat16"`` the forward runs in bf16 autocast with
f32 parameters; the ConvGRU input and the NCE inputs are f32, as in the
JAX step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
from dpc_tpu_torch.models import dpc
from dpc_tpu_torch.ops import nce, nce_cuda


def resolve_nce_impl(train_cfg: TrainConfig, model_cfg: DPCConfig,
                     device: torch.device) -> str:
    """'auto' picks by projected score bytes against the device's memory
    (``ops.nce.pick_nce_impl``); the deprecated ``fused_nce`` forces
    'fused'."""
    impl = "fused" if train_cfg.fused_nce else train_cfg.nce_impl
    if impl not in ("auto", "xla", "fused"):
        raise ValueError(
            f"nce_impl must be one of 'auto'|'xla'|'fused', got {impl!r}")
    if impl != "auto":
        return impl
    rows = train_cfg.batch_size * model_cfg.pred_step * model_cfg.sq
    return nce.pick_nce_impl(rows, rows, device)


def _check_supported(train_cfg: TrainConfig) -> None:
    unsupported = [
        (train_cfg.negatives != "local", "--negatives global",
         "queue 1 item 13 (multi-GPU)"),
        (train_cfg.model_parallel > 1, "--model_parallel > 1",
         "queue 1 item 13 (multi-GPU)"),
        (train_cfg.cross_replica_bn, "--cross_replica_bn",
         "queue 1 item 13 (multi-GPU)"),
        (train_cfg.device_augment, "--device_augment",
         "queue 1 item 12 (device augmentation)"),
        (train_cfg.remat, "--remat", "queue 1 item 10 (pretrain CLI)"),
    ]
    for bad, flag, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported to dpc_tpu_torch yet: ROADMAP.md "
                f"{item}")


def make_pretrain_step(model_cfg: DPCConfig, train_cfg: TrainConfig,
                       model: nn.Module, optimizer: torch.optim.Optimizer
                       ) -> Callable[..., dict]:
    """Build the train step: ``step(batch, generator=None) -> metrics``.

    ``batch``: ``[B, N, SL, H, W, 3]`` f32 on the model's device.
    ``generator``: a ``torch.Generator`` on that device for the GRU
    dropout (None: no dropout).  Returns ``{loss, top1, top3, top5}`` as
    0-d tensors on the device; the parameters are updated in place.
    """
    _check_supported(train_cfg)
    device = next(model.parameters()).device
    use_fused = resolve_nce_impl(train_cfg, model_cfg, device) == "fused"
    targets = torch.as_tensor(
        nce.nce_targets(train_cfg.batch_size, model_cfg.pred_step,
                        model_cfg.sq), device=device)
    bf16 = model_cfg.compute_dtype == "bfloat16"
    if model_cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {model_cfg.compute_dtype!r}")

    def step(batch: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> dict:
        if batch.shape[0] != train_cfg.batch_size:
            raise ValueError(f"batch of {batch.shape[0]} clips, config "
                             f"says {train_cfg.batch_size}")
        optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            pred, gt = dpc.predict(model, batch, cfg=model_cfg, train=True,
                                   generator=generator)
        pred, gt = pred.float(), gt.float()
        if use_fused:
            loss, metrics = nce_cuda.fused_nce_loss(pred, gt, targets)
        else:
            loss, metrics = nce.nce_loss(nce.dense_score(pred, gt), targets)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), **metrics}

    return step
