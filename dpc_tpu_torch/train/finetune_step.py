"""The LC classification steps on one device (port of
``dpc_tpu/train/finetune_step.py``; reference hot loop
``eval/test.py:218-301``).

Cross-entropy over the LC logits with top-1/top-5, the BN running
statistics updated in place by the train-mode forward, and the Adam update
applied in place with the epoch's ``lr_scale``.  Under
``compute_dtype="bfloat16"`` the forward runs in bf16 autocast with f32
parameters; the ConvGRU input and the head are f32, as in the JAX steps.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from dpc_tpu_torch.core.config import DPCConfig, EvalConfig
from dpc_tpu_torch.data import device_augment
from dpc_tpu_torch.models import lc
from dpc_tpu_torch.train import optim


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


def make_augment(model_cfg: DPCConfig, eval_cfg: EvalConfig, mode: str
                 ) -> tuple[Optional[Callable], Optional[tuple]]:
    """``(augment, input_norm)`` of the ``mode`` ('train' or 'val') recipe:
    ``augment(batch, gen)`` runs it on a uint8 batch with draws from the
    CPU generator ``gen`` (None without ``device_augment``)."""
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
        draws = device_augment.draw_finetune(gen, b, h, w, mode)
        return device_augment.finetune_augment_batch(
            batch, draws.to(batch.device), model_cfg.img_dim, mode=mode,
            normalize_out=not fold)

    return augment, input_norm


def make_finetune_step(model_cfg: DPCConfig, eval_cfg: EvalConfig,
                       model: lc.LC, optimizer: torch.optim.Optimizer
                       ) -> Callable[..., dict]:
    """Build the train step: ``step(batch, labels, generator=None,
    lr_scale=1.0, augment_gen=None) -> metrics``.

    ``batch`` ``[B, N, SL, H, W, 3]`` (f32 clips, or uint8 windows with
    ``device_augment``, whose recipe draws from the CPU generator
    ``augment_gen``) and ``labels`` ``[B]`` on the model's device;
    ``generator`` draws the GRU and head dropout (None: no dropout); every
    optimizer group runs at ``base_lr·lr_scale``.  Returns ``{loss, top1,
    top5}`` as 0-d tensors on the device.

    ``eval_cfg.remat`` recomputes the LC forward in the backward
    (``torch.utils.checkpoint``).  The recomputation replays the same
    dropout draws, and the running statistics are put back to their value
    after the forward, so the step computes what the plain step does."""
    device = next(model.parameters()).device
    augment, input_norm = make_augment(model_cfg, eval_cfg, "train")

    def forward(batch, generator):
        with _autocast(model_cfg, device):
            logits, _, _ = lc.apply_lc(model, batch, cfg=model_cfg,
                                       train=True, generator=generator,
                                       input_norm=input_norm)
        return logits[:, 0]

    def step(batch: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             lr_scale: float = 1.0,
             augment_gen: Optional[torch.Generator] = None) -> dict:
        if augment is not None:
            batch = augment(batch, augment_gen)
        optim.set_lr_scale(optimizer, lr_scale)
        optimizer.zero_grad(set_to_none=True)
        if eval_cfg.remat:
            gen_state = generator.get_state() if generator else None

            def replay(b):
                if generator is not None:
                    generator.set_state(gen_state)
                return forward(b, generator)

            logits = checkpoint.checkpoint(replay, batch, use_reentrant=False)
            stats = {k: v.clone() for k, v in model.named_buffers()}
        else:
            logits = forward(batch, generator)
        loss = softmax_xent(logits, labels)
        loss.backward()
        if eval_cfg.remat:
            for k, v in model.named_buffers():
                v.copy_(stats[k])
        optimizer.step()
        return _metrics(logits.detach(), labels)

    return step


def make_finetune_eval_step(model_cfg: DPCConfig, eval_cfg: EvalConfig,
                            model: lc.LC) -> Callable[..., dict]:
    """Validation: ``eval_step(batch, labels, augment_gen=None) -> {loss,
    top1, top5}``, the eval-mode forward (running statistics, no dropout),
    after the val recipe on the card with ``device_augment`` (the
    reference's val transform is stochastic too, ``eval/test.py:150-176``).
    """
    device = next(model.parameters()).device
    augment, input_norm = make_augment(model_cfg, eval_cfg, "val")

    @torch.no_grad()
    def eval_step(batch: torch.Tensor, labels: torch.Tensor,
                  augment_gen: Optional[torch.Generator] = None) -> dict:
        if augment is not None:
            batch = augment(batch, augment_gen)
        with _autocast(model_cfg, device):
            logits, _, _ = lc.apply_lc(model, batch, cfg=model_cfg,
                                       train=False, input_norm=input_norm)
        return _metrics(logits[:, 0], labels)

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
    conv directly.  Otherwise K = 1."""
    device = next(model.parameters()).device
    fold, input_norm = device_augment.resolve_fold(eval_cfg, dense_test=True)

    @torch.no_grad()
    def forward(windows: torch.Tensor) -> torch.Tensor:
        if eval_cfg.device_augment:
            windows = device_augment.test_preprocess_batch(
                windows, model_cfg.img_dim, test_crop,
                five_crop=eval_cfg.five_crop, normalize_out=not fold)
        with _autocast(model_cfg, device):
            logits, _, _ = lc.apply_lc(model, windows, cfg=model_cfg,
                                       train=False, input_norm=input_norm)
        return logits[:, 0]

    return forward
