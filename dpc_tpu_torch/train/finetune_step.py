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


def _check_supported(eval_cfg: EvalConfig) -> None:
    if eval_cfg.device_augment:
        raise NotImplementedError(
            "device_augment is not ported to dpc_tpu_torch yet: ROADMAP.md "
            "queue 1 item 12 (device augmentation)")


def make_finetune_step(model_cfg: DPCConfig, eval_cfg: EvalConfig,
                       model: lc.LC, optimizer: torch.optim.Optimizer
                       ) -> Callable[..., dict]:
    """Build the train step: ``step(batch, labels, generator=None,
    lr_scale=1.0) -> metrics``.

    ``batch`` ``[B, N, SL, H, W, 3]`` f32 and ``labels`` ``[B]`` on the
    model's device; ``generator`` draws the GRU and head dropout (None: no
    dropout); every optimizer group runs at ``base_lr·lr_scale``.  Returns
    ``{loss, top1, top5}`` as 0-d tensors on the device.

    ``eval_cfg.remat`` recomputes the LC forward in the backward
    (``torch.utils.checkpoint``).  The recomputation replays the same
    dropout draws, and the running statistics are put back to their value
    after the forward, so the step computes what the plain step does."""
    _check_supported(eval_cfg)
    device = next(model.parameters()).device

    def forward(batch, generator):
        with _autocast(model_cfg, device):
            logits, _, _ = lc.apply_lc(model, batch, cfg=model_cfg,
                                       train=True, generator=generator)
        return logits[:, 0]

    def step(batch: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             lr_scale: float = 1.0) -> dict:
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
    """Validation: ``eval_step(batch, labels) -> {loss, top1, top5}``, the
    eval-mode forward (running statistics, no dropout)."""
    _check_supported(eval_cfg)
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch: torch.Tensor, labels: torch.Tensor) -> dict:
        with _autocast(model_cfg, device):
            logits, _, _ = lc.apply_lc(model, batch, cfg=model_cfg,
                                       train=False)
        return _metrics(logits[:, 0], labels)

    return eval_step


def make_test_forward(model_cfg: DPCConfig, eval_cfg: EvalConfig,
                      model: lc.LC) -> Callable[[torch.Tensor], torch.Tensor]:
    """The dense-test forward: ``forward(windows [WB, N, SL, H, W, 3]) ->
    logits [WB, C]`` in eval mode; the window axis rides the batch axis
    (``eval/test.py:314-321``)."""
    _check_supported(eval_cfg)
    device = next(model.parameters()).device

    @torch.no_grad()
    def forward(windows: torch.Tensor) -> torch.Tensor:
        with _autocast(model_cfg, device):
            logits, _, _ = lc.apply_lc(model, windows, cfg=model_cfg,
                                       train=False)
        return logits[:, 0]

    return forward
