"""The DPC pretraining train and validation steps on one device (port of
``dpc_tpu/train/pretrain_step.py:47-316``).

One step is forward, loss, backward and the Adam update, applied in place
to the model's parameters; the validation step is the forward and the loss
alone, without dropout.  Negatives are local: the device scores its own
batch only, which is the reference's per-GPU pool (``dpc/main.py:180,212``).
Under ``compute_dtype="bfloat16"`` the forward runs in bf16 autocast with
f32 parameters; the ConvGRU input and the NCE inputs are f32, as in the
JAX step.  With ``device_augment`` the batch is the host half's uint8
windows, and the pretrain recipe (``data.device_augment.augment_batch``)
runs first, its draws taken from the step's augmentation generator; the
normalize goes into the stem conv when ``fold_normalize`` resolves so.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
from dpc_tpu_torch.data import device_augment
from dpc_tpu_torch.models import dpc
from dpc_tpu_torch.ops import nce, nce_cuda
from dpc_tpu_torch.utils import profiling


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
    ]
    for bad, flag, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported to dpc_tpu_torch yet: ROADMAP.md "
                f"{item}")


def make_augment(model_cfg: DPCConfig, train_cfg: TrainConfig
                 ) -> tuple[Optional[Callable], Optional[tuple]]:
    """``(augment, input_norm)``: ``augment(batch, gen)`` runs the pretrain
    recipe on a uint8 batch with draws from the CPU generator ``gen`` (None
    without ``device_augment``), and ``input_norm`` is the model's stem
    fold (``device_augment.resolve_fold``)."""
    fold, input_norm = device_augment.resolve_fold(train_cfg)
    if not train_cfg.device_augment:
        return None, input_norm
    recipe = train_cfg.device_augment_recipe

    def augment(batch: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        if gen is None:
            raise ValueError("device_augment draws from an augmentation "
                             "generator; the step was given none")
        if batch.dtype != torch.uint8:
            raise ValueError(f"device_augment takes uint8 windows, got "
                             f"{batch.dtype}")
        b, n, sl, h, w, _ = batch.shape
        draws = device_augment.draw_pretrain(gen, b, n * sl, h, w, recipe)
        return device_augment.augment_batch(
            batch, draws.to(batch.device), model_cfg.img_dim, recipe=recipe,
            normalize_out=not fold)

    return augment, input_norm


def make_pretrain_step(model_cfg: DPCConfig, train_cfg: TrainConfig,
                       model: nn.Module, optimizer: torch.optim.Optimizer
                       ) -> Callable[..., dict]:
    """Build the train step: ``step(batch, generator=None,
    augment_gen=None) -> metrics``.

    ``batch``: ``[B, N, SL, H, W, 3]`` on the model's device, f32 clips, or
    uint8 windows with ``train_cfg.device_augment``, whose recipe draws
    from the CPU ``torch.Generator`` ``augment_gen``.  ``generator``: a
    ``torch.Generator`` on that device for the GRU dropout (None: no
    dropout).  Returns ``{loss, top1, top3, top5}`` as 0-d tensors on the
    device; the parameters are updated in place.  Under
    ``profiling.enable_debug`` (``--debug_nans``) a non-finite loss raises
    before the backward.  ``train_cfg.remat``
    recomputes the backbone's activations in the backward (activation
    checkpointing; the backbone draws no dropout and keeps no running
    statistics, so the recomputation is exact).
    """
    _check_supported(train_cfg)
    device = next(model.parameters()).device
    augment, input_norm = make_augment(model_cfg, train_cfg)
    loss_fn = make_nce_loss(model_cfg, train_cfg, device)
    bf16 = model_cfg.compute_dtype == "bfloat16"
    if model_cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {model_cfg.compute_dtype!r}")

    def step(batch: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             augment_gen: Optional[torch.Generator] = None) -> dict:
        if batch.shape[0] != train_cfg.batch_size:
            raise ValueError(f"batch of {batch.shape[0]} clips, config "
                             f"says {train_cfg.batch_size}")
        if augment is not None:
            batch = augment(batch, augment_gen)
        optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            pred, gt = dpc.predict(model, batch, cfg=model_cfg, train=True,
                                   generator=generator,
                                   remat=train_cfg.remat,
                                   input_norm=input_norm)
        loss, metrics = loss_fn(pred, gt)
        if profiling.nan_checks_on():  # --debug_nans
            profiling.check_finite(loss)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), **metrics}

    return step


def make_nce_loss(model_cfg: DPCConfig, train_cfg: TrainConfig,
                  device: torch.device) -> Callable[..., tuple]:
    """``loss_fn(pred, gt) -> (loss, {top1, top3, top5})`` over the local
    batch, through the flash kernels or the materialised score as
    ``resolve_nce_impl`` picks."""
    use_fused = resolve_nce_impl(train_cfg, model_cfg, device) == "fused"
    targets = torch.as_tensor(
        nce.nce_targets(train_cfg.batch_size, model_cfg.pred_step,
                        model_cfg.sq), device=device)

    def loss_fn(pred, gt):
        pred, gt = pred.float(), gt.float()
        if use_fused:
            return nce_cuda.fused_nce_loss(pred, gt, targets)
        return nce.nce_loss(nce.dense_score(pred, gt), targets)

    return loss_fn


def make_eval_step(model_cfg: DPCConfig, train_cfg: TrainConfig,
                   model: nn.Module) -> Callable[..., dict]:
    """Validation: ``eval_step(batch, augment_gen=None) -> {loss, top1,
    top3, top5}``, the forward and the loss under ``torch.no_grad()`` with
    no dropout (reference ``validate``, ``dpc/main.py:249-282``), after the
    train step's device recipe when ``device_augment`` is set.  It
    resolves the NCE path as the train step does, so a run whose train
    steps fit does not run out of memory in validation; ``fused`` runs the
    forward kernel alone."""
    _check_supported(train_cfg)
    device = next(model.parameters()).device
    augment, input_norm = make_augment(model_cfg, train_cfg)
    loss_fn = make_nce_loss(model_cfg, train_cfg, device)
    bf16 = model_cfg.compute_dtype == "bfloat16"
    if model_cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {model_cfg.compute_dtype!r}")

    @torch.no_grad()
    def eval_step(batch: torch.Tensor,
                  augment_gen: Optional[torch.Generator] = None) -> dict:
        if batch.shape[0] != train_cfg.batch_size:
            raise ValueError(f"batch of {batch.shape[0]} clips, config "
                             f"says {train_cfg.batch_size}")
        if augment is not None:
            batch = augment(batch, augment_gen)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            pred, gt = dpc.predict(model, batch, cfg=model_cfg, train=False,
                                   input_norm=input_norm)
        loss, metrics = loss_fn(pred, gt)
        return {"loss": loss, **metrics}

    return eval_step
