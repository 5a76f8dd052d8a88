"""The DPC pretraining train and validation steps, on one device or one
rank of several (port of ``dpc_tpu/train/pretrain_step.py:47-316``).

One step is forward, loss, backward and the Adam update, applied in place
to the model's parameters; the validation step is the forward and the loss
alone, without dropout.  Under ``compute_dtype="bfloat16"`` the forward
runs in bf16 autocast with f32 parameters; the ConvGRU input and the NCE
inputs are f32, as in the JAX step.  With ``device_augment`` the batch is
the host half's uint8 windows, and the pretrain recipe
(``data.device_augment.augment_batch``) runs first, its draws taken from
the step's augmentation generator; the normalize goes into the stem conv
when ``fold_normalize`` resolves so.

With a ``parallel.mesh.Mesh`` of several ranks, each rank runs the step
on its rows of the global batch (``mesh.shard_batch``), as ``dpc_tpu``'s
``shard_map`` body runs on each device:

  * ``negatives='local'``: each data shard scores its own clips, the
    reference's per-GPU pool (``dpc/main.py:180,212``);
  * ``'global'``: the GT embeddings are gathered over the data group, so
    every shard scores against the whole batch;
  * a model axis (``model_parallel > 1``, global negatives only) shards
    the clips of a data group over its peers: each encodes its own, the
    embeddings are gathered over the model group, and the candidate pool
    is sharded over it (``ops/sharded_nce.py``; K7 under ``fused``);
  * ``cross_replica_bn`` takes the BN statistics over every rank; without
    it they span the model group of a clip-sharded step (the data
    shard's clips), else this rank's batch.

The gradients are averaged over every rank in one all-reduce (the mean
over the model group, which removes the gather's m-factor, then over the
data group), together with the metrics, and the same Adam update runs on
every rank.  One rank makes no collective call.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
from dpc_tpu_torch.data import device_augment
from dpc_tpu_torch.models import dpc
from dpc_tpu_torch.ops import nce, nce_cuda, sharded_nce
from dpc_tpu_torch.parallel import collectives as C
from dpc_tpu_torch.parallel.mesh import Mesh, peer_rows
from dpc_tpu_torch.utils import profiling

METRICS = ("loss", "top1", "top3", "top5")


def resolve_nce_impl(train_cfg: TrainConfig, model_cfg: DPCConfig,
                     device: torch.device, n_data: int = 1,
                     n_model: int = 1) -> str:
    """'auto' picks by projected score bytes against the device's memory
    (``ops.nce.pick_nce_impl``) for this rank's tile: its data group's rows
    against the local or global pool, 1/``n_model`` of it; the deprecated
    ``fused_nce`` forces 'fused'."""
    impl = "fused" if train_cfg.fused_nce else train_cfg.nce_impl
    if impl not in ("auto", "xla", "fused"):
        raise ValueError(
            f"nce_impl must be one of 'auto'|'xla'|'fused', got {impl!r}")
    if impl != "auto":
        return impl
    cells = model_cfg.pred_step * model_cfg.sq
    rows = train_cfg.batch_size // n_data * cells
    cols_b = (train_cfg.batch_size if train_cfg.negatives == "global"
              else train_cfg.batch_size // n_data)
    return nce.pick_nce_impl(rows, cols_b * cells // n_model,
                             model_cfg.feature_size, device)


def check_layout(train_cfg: TrainConfig, n_data: int, n_model: int) -> None:
    """Raise ``ValueError`` for a layout the steps refuse: the guards of
    ``dpc_tpu``'s steps (``:121-137``), checkable before any rank starts."""
    _Layout(train_cfg, Mesh(n_data, n_model, 0))


class _Layout:
    """What a step needs of the mesh: the axis sizes, the clip split, the
    BN group and the guards of ``dpc_tpu``'s steps (``:121-137``)."""

    def __init__(self, train_cfg: TrainConfig, mesh: Optional[Mesh]):
        if mesh is not None and mesh.size == 1:
            mesh = None
        if mesh is None and train_cfg.model_parallel > 1:
            raise ValueError(f"model_parallel={train_cfg.model_parallel} "
                             "needs a mesh with a model axis "
                             "(parallel.mesh.make_mesh)")
        self.mesh = mesh
        self.n_data = mesh.n_data if mesh else 1
        self.n_model = mesh.n_model if mesh else 1
        self.shard_clips = self.n_model > 1
        if train_cfg.batch_size % (self.n_data * self.n_model):
            raise ValueError(f"batch {train_cfg.batch_size} not divisible "
                             f"by {self.n_data * self.n_model} ranks")
        self.local_b = train_cfg.batch_size // self.n_data
        if self.shard_clips and self.local_b % self.n_model:
            raise ValueError(f"per-data-group batch {self.local_b} not "
                             f"divisible by model_parallel={self.n_model}")
        if self.shard_clips and train_cfg.negatives != "global":
            raise ValueError("--model_parallel > 1 requires --negatives "
                             "global (the model axis shards clips + the "
                             "global candidate pool)")
        if train_cfg.negatives not in ("local", "global"):
            raise ValueError(f"negatives {train_cfg.negatives!r}")
        self.rank_b = self.local_b // self.n_model
        if mesh is None:
            self.bn_group = None
        elif train_cfg.cross_replica_bn:
            self.bn_group = mesh.world_group
        else:
            # the data shard's clips: the reference's per-GPU BN
            self.bn_group = mesh.model_group

    def check_batch(self, batch: torch.Tensor) -> None:
        if batch.shape[0] != self.rank_b:
            raise ValueError(f"batch of {batch.shape[0]} clips, the rank's "
                             f"share of the config's batch is {self.rank_b}")


def make_augment(model_cfg: DPCConfig, train_cfg: TrainConfig,
                 mesh: Optional[Mesh] = None
                 ) -> tuple[Optional[Callable], Optional[tuple]]:
    """``(augment, input_norm)``: ``augment(batch, gen)`` runs the pretrain
    recipe on a uint8 batch with draws from the CPU generator ``gen`` (None
    without ``device_augment``), and ``input_norm`` is the model's stem
    fold (``device_augment.resolve_fold``).  On a model axis the draws are
    made for the whole data group and each peer takes its clips' share
    (``mesh.peer_rows``), so a clip draws the same on 1 or m peers."""
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
        n_draw, first = peer_rows(mesh, b)
        draws = device_augment.draw_pretrain(gen, n_draw, n * sl, h, w,
                                             recipe)
        if n_draw != b:
            draws = draws.rows(first, b)
        return device_augment.augment_batch(
            batch, draws.to(batch.device), model_cfg.img_dim, recipe=recipe,
            normalize_out=not fold)

    return augment, input_norm


def make_pretrain_step(model_cfg: DPCConfig, train_cfg: TrainConfig,
                       model: nn.Module, optimizer: torch.optim.Optimizer,
                       mesh: Optional[Mesh] = None) -> Callable[..., dict]:
    """Build the train step: ``step(batch, generator=None,
    augment_gen=None) -> metrics``.

    ``batch``: this rank's ``[B / ranks, N, SL, H, W, 3]`` on the model's
    device (all of the batch on one device), f32 clips, or uint8 windows
    with ``train_cfg.device_augment``, whose recipe draws from the CPU
    ``torch.Generator`` ``augment_gen``.  ``generator``: a
    ``torch.Generator`` on that device for the GRU dropout (None: no
    dropout).  On several ranks the caller seeds them per rank
    (``mesh.data_seed``, ``mesh.dropout_seed``).  Returns ``{loss, top1,
    top3, top5}`` as 0-d tensors on the device, averaged over the ranks;
    the parameters are updated in place, the same on every rank.  Under
    ``profiling.enable_debug`` (``--debug_nans``) a non-finite loss raises
    before the backward.  ``train_cfg.remat`` recomputes the backbone's
    activations in the backward (activation checkpointing; the backbone
    draws no dropout and keeps no running statistics, so the recomputation
    is exact).
    """
    layout = _Layout(train_cfg, mesh)
    device = next(model.parameters()).device
    augment, input_norm = make_augment(model_cfg, train_cfg, layout.mesh)
    loss_fn = make_nce_loss(model_cfg, train_cfg, device, layout)
    bf16 = model_cfg.compute_dtype == "bfloat16"
    if model_cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {model_cfg.compute_dtype!r}")
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             augment_gen: Optional[torch.Generator] = None) -> dict:
        layout.check_batch(batch)
        if augment is not None:
            batch = augment(batch, augment_gen)
        optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            pred, gt = dpc.predict(model, batch, cfg=model_cfg, train=True,
                                   generator=generator,
                                   remat=train_cfg.remat,
                                   input_norm=input_norm,
                                   bn_group=layout.bn_group)
        loss, metrics = loss_fn(pred, gt)
        if profiling.nan_checks_on():  # --debug_nans
            profiling.check_finite(loss)
        loss.backward()
        metrics = {"loss": loss.detach(), **metrics}
        if layout.mesh is not None:
            metrics = {k: metrics[k].clone() for k in METRICS}
            grads = [p.grad for p in params if p.grad is not None]
            C.mean_flat_(grads + list(metrics.values()),
                         layout.mesh.world_group)
        optimizer.step()
        return metrics

    return step


def make_nce_loss(model_cfg: DPCConfig, train_cfg: TrainConfig,
                  device: torch.device, layout: Optional[_Layout] = None
                  ) -> Callable[..., tuple]:
    """``loss_fn(pred, gt) -> (loss, {top1, top3, top5})`` of this rank,
    through the flash kernels or the materialised score as
    ``resolve_nce_impl`` picks: over the local batch; against the pool
    gathered over the data group (global negatives); or over this model
    peer's candidate shard after gathering the data group's embeddings
    over the model group (``sharded_nce``, the four branches of
    ``dpc_tpu``'s ``loss_fn``)."""
    layout = layout or _Layout(train_cfg, None)
    mesh = layout.mesh
    impl = resolve_nce_impl(train_cfg, model_cfg, device, layout.n_data,
                            layout.n_model)
    use_fused = impl == "fused"
    targets = torch.as_tensor(
        nce.nce_targets(layout.local_b, model_cfg.pred_step, model_cfg.sq),
        device=device)
    global_pool = train_cfg.negatives == "global" and layout.n_data > 1
    if global_pool and not layout.shard_clips:
        # the positive of local row (b, p, q) is global column
        # ((shard·B_l + b), p, q)
        targets = targets + mesh.data_index * targets.shape[0]

    def loss_fn(pred, gt):
        pred, gt = pred.float(), gt.float()
        if layout.shard_clips:
            pred = C.all_gather(pred, mesh.model_group)
            gt = C.all_gather(gt, mesh.model_group)
            return sharded_nce.sharded_nce_loss(pred, gt, mesh, impl=impl)
        if global_pool:
            gt = C.all_gather(gt, mesh.data_group)
        if use_fused:
            return nce_cuda.fused_nce_loss(pred, gt, targets)
        return nce.nce_loss(nce.dense_score(pred, gt), targets)

    return loss_fn


def make_eval_step(model_cfg: DPCConfig, train_cfg: TrainConfig,
                   model: nn.Module, mesh: Optional[Mesh] = None
                   ) -> Callable[..., dict]:
    """Validation: ``eval_step(batch, augment_gen=None) -> {loss, top1,
    top3, top5}``, the forward and the loss under ``torch.no_grad()`` with
    no dropout (reference ``validate``, ``dpc/main.py:249-282``), after the
    train step's device recipe when ``device_augment`` is set, averaged
    over the ranks.  It takes the train step's layout, guards and NCE
    path, so a run whose train steps fit does not run out of memory in
    validation; ``fused`` runs the forward kernels alone.  Its BN spans
    the model group of a clip-sharded step, as ``dpc_tpu``'s does, and no
    more even with ``cross_replica_bn``."""
    layout = _Layout(train_cfg, mesh)
    layout.bn_group = layout.mesh.model_group if layout.shard_clips else None
    device = next(model.parameters()).device
    augment, input_norm = make_augment(model_cfg, train_cfg, layout.mesh)
    loss_fn = make_nce_loss(model_cfg, train_cfg, device, layout)
    bf16 = model_cfg.compute_dtype == "bfloat16"
    if model_cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {model_cfg.compute_dtype!r}")

    @torch.no_grad()
    def eval_step(batch: torch.Tensor,
                  augment_gen: Optional[torch.Generator] = None) -> dict:
        layout.check_batch(batch)
        if augment is not None:
            batch = augment(batch, augment_gen)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            pred, gt = dpc.predict(model, batch, cfg=model_cfg, train=False,
                                   input_norm=input_norm,
                                   bn_group=layout.bn_group)
        loss, metrics = loss_fn(pred, gt)
        metrics = {"loss": loss, **metrics}
        if layout.mesh is not None:
            metrics = {k: metrics[k].clone() for k in METRICS}
            C.mean_flat_(list(metrics.values()), layout.mesh.world_group)
        return metrics

    return eval_step
