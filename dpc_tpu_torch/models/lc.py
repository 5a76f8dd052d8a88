"""LC: the downstream action classifier over the DPC trunk (port of
``dpc_tpu/models/lc.py``; reference ``eval/model_3d_lc.py``).

backbone → ReLU → temporal mean → ConvGRU over ALL blocks → last step →
spatial mean → feature-axis BatchNorm1d → dropout → linear.  As in the
reference:
  * the backbone keeps BN running statistics (``:26-28``), unlike
    pretraining;
  * ReLU comes BEFORE the temporal mean (``:53-55``; the DPC head pools
    first);
  * ``final_bn`` is a BatchNorm1d over the D features (``:39-41,62``);
  * the head is Dropout(p) + Linear with orthogonal weight and zero bias
    (``:43-45,67-73``);
  * the returned context is POST-``final_bn`` (``:62-64``).
Module names are the reference's: ``backbone``, ``agg``, ``final_bn``,
``final_fc.1``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dpc_tpu_torch.core.config import DPCConfig
from dpc_tpu_torch.models import convgru, layers as L, resnet2d3d


class LC(nn.Module):
    def __init__(self, cfg: DPCConfig, num_classes: int,
                 dropout: float = 0.5):
        super().__init__()
        d = cfg.feature_size
        self.backbone = resnet2d3d.ResNet2d3d(cfg.network,
                                              track_running_stats=True)
        self.agg = convgru.ConvGRU(d, d, cfg.gru_kernel_size,
                                   cfg.gru_num_layers)
        self.final_bn = nn.BatchNorm1d(d, eps=1e-5, momentum=0.1)
        # the Dropout module keeps the reference's layout (final_fc.1 is the
        # linear); apply_lc draws its mask from the caller's generator
        self.final_fc = nn.Sequential(nn.Dropout(dropout),
                                      L.linear_orthogonal(d, num_classes))


def build_lc(cfg: DPCConfig, num_classes: int, device: torch.device,
             dropout: float = 0.5, seed: int = 0) -> LC:
    """An LC model with weights drawn from ``seed``, on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LC(cfg, num_classes, dropout)
    model = model.to(device)
    if device.type == "cuda":
        # cuDNN's fast 3-D convs want NDHWC, which is also the public layout
        model.backbone.to(memory_format=torch.channels_last_3d)
    return model


def running_stats(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's BN running statistics by state_dict name (the module's
    own buffers, not copies)."""
    return {k: v for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def apply_lc(model: LC, x: torch.Tensor, *, cfg: DPCConfig,
             train: bool = True, generator: Optional[torch.Generator] = None,
             input_norm: Optional[tuple] = None, bn_group=None
             ) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Forward.  x: ``[B, N, SL, H, W, 3]`` → (logits ``[B, 1, C]``,
    context ``[B, 1, D]``, running stats).

    ``train`` puts the model in train mode (batch statistics, running
    statistics updated in place, as torch's BN does) or eval mode (running
    statistics).  The GRU dropout and then the head dropout are drawn from
    ``generator``; without one there is no dropout.  The head runs in f32
    outside autocast, as the JAX head computes in the f32 of its input.
    ``input_norm=(mean, std, scale)``: ``x`` is un-normalised ([0, 1] f32
    or raw uint8) and the stem conv normalises it
    (``layers.conv3d_input_norm``).  ``bn_group``: the process group over
    which the backbone's BNs and ``final_bn`` take their batch statistics
    in train mode (``layers.batchnorm``; ``dpc_tpu``'s ``axis_name``, the
    model group of a clip-sharded step); eval mode uses the running
    statistics and makes no collective call.
    """
    model.train(train)
    b, n, sl, h, w, c = x.shape
    feat = model.backbone(x.reshape(b * n, sl, h, w, c), input_norm,
                          bn_group)
    feat = F.relu(feat).float().mean(dim=1)        # ReLU before the pool
    ls = cfg.last_size
    feat = feat.reshape(b, n, ls, ls, cfg.feature_size)
    outputs, _ = convgru.apply_convgru(
        model.agg, feat, dropout=cfg.gru_dropout, train=train,
        generator=generator, impl=cfg.gru_impl)
    context = outputs[:, -1].float().mean(dim=(1, 2))   # [B, D]
    with torch.autocast(x.device.type, enabled=False):
        normed = L.batchnorm(model.final_bn, context, bn_group)
        drop, fc = model.final_fc
        out = L.dropout(normed, drop.p, generator, train)
        logits = fc(out)
    return logits[:, None], normed[:, None], running_stats(model)
