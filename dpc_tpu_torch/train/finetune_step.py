"""The LC classification steps, on one device or one rank of several
(port of ``dpc_tpu/train/finetune_step.py``; reference hot loop
``eval/test.py:218-301``).

Cross-entropy over the LC logits with top-1/top-5, the BN running
statistics updated in place by the train-mode forward, and the Adam update
applied in place with the epoch's ``lr_scale``.  Under
``compute_dtype="bfloat16"`` the forward runs in bf16 autocast with f32
parameters; the ConvGRU input and the head are f32, as in the JAX steps.

With a ``parallel.mesh.Mesh`` of several ranks each rank runs the step on
its rows of the global batch (``mesh.shard_batch``), as ``dpc_tpu``'s
``shard_map`` body runs on each device (``_clip_layout``, ``:25-49``): a
model axis of m > 1 shards the clips over ``(data, model)`` too, and the
BN batch statistics then span the model group, the data shard's clips,
so ``{data:d, model:m}`` computes what ``{data:d}`` does.  Cross-entropy
is per sample: each rank's loss is the mean over its own rows, and the
mean of the gradients over every rank is the global batch's.  One
all-reduce averages the gradients, the metrics and the BN running
statistics over every rank (``dpc_tpu``'s choice: the reference's
DataParallel keeps the running statistics per replica), and every rank
runs the same Adam update.  One rank makes no collective call.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from dpc_tpu_torch.core.config import DPCConfig, EvalConfig
from dpc_tpu_torch.data import device_augment
from dpc_tpu_torch.models import lc
from dpc_tpu_torch.parallel import collectives as C
from dpc_tpu_torch.parallel.mesh import Mesh, peer_rows
from dpc_tpu_torch.train import optim
from dpc_tpu_torch.utils import profiling


class _ClipLayout:
    """What the LC steps need of the mesh (``dpc_tpu``'s ``_clip_layout``):
    the BN group (the model group when clips are sharded over a model
    axis), the group of the means over every rank (None for one rank) and
    the guard."""

    def __init__(self, mesh: Optional[Mesh], batch_size: int):
        n_data = mesh.n_data if mesh else 1
        n_model = mesh.n_model if mesh else 1
        if n_model > 1 and (batch_size // n_data) % n_model:
            raise ValueError(f"per-data-group batch {batch_size // n_data} "
                             f"not divisible by model_parallel={n_model}")
        self.bn_group = mesh.model_group if n_model > 1 else None
        self.world_group = mesh.world_group if mesh else None


def check_layout(batch_size: int, n_data: int, n_model: int) -> None:
    """Raise ``ValueError`` for a layout the LC steps refuse, checkable
    before any rank starts (as ``pretrain_step.check_layout``)."""
    _ClipLayout(Mesh(n_data, n_model, 0), batch_size)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


def _accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int
              ) -> torch.Tensor:
    idx = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
    return (idx == labels[:, None]).any(dim=-1).float().mean()


def _metrics(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    return {"loss": softmax_xent(logits, labels).detach(),
            "top1": _accuracy(logits, labels, 1),
            "top5": _accuracy(logits, labels, 5)}


def _autocast(model_cfg: DPCConfig, device: torch.device):
    if model_cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {model_cfg.compute_dtype!r}")
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=model_cfg.compute_dtype == "bfloat16")


def make_augment(model_cfg: DPCConfig, eval_cfg: EvalConfig, mode: str,
                 mesh: Optional[Mesh] = None
                 ) -> tuple[Optional[Callable], Optional[tuple]]:
    """``(augment, input_norm)`` of the ``mode`` ('train' or 'val') recipe:
    ``augment(batch, gen)`` runs it on a uint8 batch with draws from the
    CPU generator ``gen`` (None without ``device_augment``).  On a model
    axis the draws are made for the whole data group and each peer takes
    its clips' share (``mesh.peer_rows``), so a clip draws the same on 1
    or m peers."""
    fold, input_norm = device_augment.resolve_fold(eval_cfg)
    if not eval_cfg.device_augment:
        return None, input_norm

    def augment(batch: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        if gen is None:
            raise ValueError("device_augment draws from an augmentation "
                             "generator; the step was given none")
        if batch.dtype != torch.uint8:
            raise ValueError(f"device_augment takes uint8 windows, got "
                             f"{batch.dtype}")
        b, _, _, h, w, _ = batch.shape
        n_draw, first = peer_rows(mesh, b)
        draws = device_augment.draw_finetune(gen, n_draw, h, w, mode)
        if n_draw != b:
            draws = draws.rows(first, b)
        return device_augment.finetune_augment_batch(
            batch, draws.to(batch.device), model_cfg.img_dim, mode=mode,
            normalize_out=not fold)

    return augment, input_norm


def make_finetune_step(model_cfg: DPCConfig, eval_cfg: EvalConfig,
                       model: lc.LC, optimizer: torch.optim.Optimizer,
                       mesh: Optional[Mesh] = None) -> Callable[..., dict]:
    """Build the train step: ``step(batch, labels, generator=None,
    lr_scale=1.0, augment_gen=None) -> metrics``.

    ``batch`` ``[B, N, SL, H, W, 3]`` (f32 clips, or uint8 windows with
    ``device_augment``, whose recipe draws from the CPU generator
    ``augment_gen``) and ``labels`` ``[B]`` on the model's device, this
    rank's rows of the global batch on several ranks; ``generator`` draws
    the GRU and head dropout (None: no dropout); every optimizer group
    runs at ``base_lr·lr_scale``.  On several ranks the caller seeds the
    generators per rank: ``mesh.dropout_seed`` decorrelates the dropout
    of model peers, which hold different clips (``dpc_tpu`` folds the
    model index into the step's key), and ``mesh.data_seed`` gives model
    peers one augmentation stream.  Returns ``{loss, top1, top5}`` as 0-d
    tensors on the device, averaged over the ranks; the parameters are
    updated in place, the same on every rank.

    ``eval_cfg.remat`` recomputes the LC forward in the backward
    (``torch.utils.checkpoint``).  The recomputation replays the same
    dropout draws, and the running statistics are put back to their value
    after the forward, so the step computes what the plain step does."""
    layout = _ClipLayout(mesh, eval_cfg.batch_size)
    device = next(model.parameters()).device
    augment, input_norm = make_augment(model_cfg, eval_cfg, "train", mesh)
    params = [p for p in model.parameters() if p.requires_grad]

    def forward(batch, generator):
        with _autocast(model_cfg, device):
            logits, _, _ = lc.apply_lc(model, batch, cfg=model_cfg,
                                       train=True, generator=generator,
                                       input_norm=input_norm,
                                       bn_group=layout.bn_group)
        return logits[:, 0]

    def step(batch: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             lr_scale: float = 1.0,
             augment_gen: Optional[torch.Generator] = None) -> dict:
        if augment is not None:
            with profiling.span("dpc.step.recipe"):
                batch = augment(batch, augment_gen)
        optim.set_lr_scale(optimizer, lr_scale)
        optimizer.zero_grad(set_to_none=True)
        with profiling.span("dpc.step.forward"):
            if eval_cfg.remat:
                gen_state = generator.get_state() if generator else None

                def replay(b):
                    if generator is not None:
                        generator.set_state(gen_state)
                    return forward(b, generator)

                logits = checkpoint.checkpoint(replay, batch,
                                               use_reentrant=False)
                stats = {k: v.clone() for k, v in model.named_buffers()}
            else:
                logits = forward(batch, generator)
        with profiling.span("dpc.step.loss"):
            loss = softmax_xent(logits, labels)
            metrics = _metrics(logits.detach(), labels)
        with profiling.span("dpc.step.backward"):
            loss.backward()
        if eval_cfg.remat:
            for k, v in model.named_buffers():
                v.copy_(stats[k])
        if layout.world_group is not None:
            grads = [p.grad for p in params if p.grad is not None]
            with profiling.span("dpc.step.allreduce"):
                C.mean_flat_(grads + list(metrics.values())
                             + list(lc.running_stats(model).values()),
                             layout.world_group)
        with profiling.span("dpc.step.optimizer"):
            optimizer.step()
        return metrics

    return step


def make_finetune_eval_step(model_cfg: DPCConfig, eval_cfg: EvalConfig,
                            model: lc.LC, mesh: Optional[Mesh] = None
                            ) -> Callable[..., dict]:
    """Validation: ``eval_step(batch, labels, augment_gen=None) -> {loss,
    top1, top5}``, the eval-mode forward (running statistics, no dropout),
    after the val recipe on the card with ``device_augment`` (the
    reference's val transform is stochastic too, ``eval/test.py:150-176``).
    On several ranks each takes its rows (clip-sharded over a model axis
    too: the eval-mode forward is per sample, so the split is exact) and
    the metrics are averaged over every rank."""
    layout = _ClipLayout(mesh, eval_cfg.batch_size)
    device = next(model.parameters()).device
    augment, input_norm = make_augment(model_cfg, eval_cfg, "val", mesh)

    @torch.no_grad()
    def eval_step(batch: torch.Tensor, labels: torch.Tensor,
                  augment_gen: Optional[torch.Generator] = None) -> dict:
        if augment is not None:
            with profiling.span("dpc.step.recipe"):
                batch = augment(batch, augment_gen)
        with profiling.span("dpc.step.forward"), _autocast(model_cfg,
                                                           device):
            logits, _, _ = lc.apply_lc(model, batch, cfg=model_cfg,
                                       train=False, input_norm=input_norm)
        with profiling.span("dpc.step.loss"):
            metrics = _metrics(logits[:, 0], labels)
        if layout.world_group is not None:
            with profiling.span("dpc.step.allreduce"):
                C.mean_flat_(list(metrics.values()), layout.world_group)
        return metrics

    return eval_step


def make_test_forward(model_cfg: DPCConfig, eval_cfg: EvalConfig,
                      model: lc.LC, test_crop: int = 224
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The dense-test forward: ``forward(windows [WB, N, SL, H, W, 3]) ->
    logits [WB·K, C]`` in eval mode; the window axis rides the batch axis
    (``eval/test.py:314-321``).  With ``device_augment`` the windows are
    uint8 and the test recipe (centre or, with ``five_crop``, K = 5 crops
    of ``test_crop``, each row's crops contiguous) runs here first; 'auto'
    folds its normalize into the stem, so the uint8 windows feed the stem
    conv directly.  Otherwise K = 1.  It is per row and makes no
    collective call: on several ranks each runs its own windows
    (``evaluate.run_test``)."""
    device = next(model.parameters()).device
    fold, input_norm = device_augment.resolve_fold(eval_cfg, dense_test=True)

    @torch.no_grad()
    def forward(windows: torch.Tensor) -> torch.Tensor:
        if eval_cfg.device_augment:
            with profiling.span("dpc.step.recipe"):
                windows = device_augment.test_preprocess_batch(
                    windows, model_cfg.img_dim, test_crop,
                    five_crop=eval_cfg.five_crop, normalize_out=not fold)
        with profiling.span("dpc.step.forward"), _autocast(model_cfg,
                                                           device):
            logits, _, _ = lc.apply_lc(model, windows, cfg=model_cfg,
                                       train=False, input_norm=input_norm)
        return logits[:, 0]

    return forward
