"""DPC-RNN: dense predictive coding (port of ``dpc_tpu/models/dpc.py``).

Encode every block with the 2D-3D ResNet, aggregate the first
``num_seq − pred_step`` block embeddings with the ConvGRU, roll out the
remaining ``pred_step`` embeddings with a 2-layer 1×1-conv predictor, and
score every predicted cell against every ground-truth cell.

Semantics kept from the reference (``dpc/model_3d.py``):
  * the GT embeddings are PRE-ReLU, the GRU consumes ReLU'd features
    (``:53-58``);
  * the temporal mean over ``last_duration`` frames is taken in f32;
  * the rollout feeds ReLU'd predictions back through the aggregator and
    scores the raw predictions (``:65-72``); GRU dropout stays live in it;
  * module names ``backbone``, ``agg``, ``network_pred.{0,2}``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from dpc_tpu_torch.core.config import DPCConfig
from dpc_tpu_torch.models import convgru, layers as L, resnet2d3d
from dpc_tpu_torch.ops import nce


class DPC(nn.Module):
    def __init__(self, cfg: DPCConfig):
        super().__init__()
        d = cfg.feature_size
        self.backbone = resnet2d3d.ResNet2d3d(cfg.network)
        self.agg = convgru.ConvGRU(d, d, cfg.gru_kernel_size,
                                   cfg.gru_num_layers)
        self.network_pred = nn.Sequential(L.conv2d(d, d, 1), nn.ReLU(),
                                          L.conv2d(d, d, 1))


def build_dpc(cfg: DPCConfig, device: torch.device, seed: int = 0) -> DPC:
    """A DPC model with weights drawn from ``seed``, on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = DPC(cfg)
    model = model.to(device)
    if device.type == "cuda":
        # cuDNN's fast 3-D convs want NDHWC, which is also the public layout
        model.backbone.to(memory_format=torch.channels_last_3d)
    return model


def _predictor(model: DPC, h: torch.Tensor) -> torch.Tensor:
    """φ: 2× 1×1 conv with ReLU between, channels-last."""
    p0, _, p2 = model.network_pred
    return L.conv2d_cl(p2, F.relu(L.conv2d_cl(p0, h)))


def encode_blocks(model: DPC, x: torch.Tensor, cfg: DPCConfig,
                  remat: bool = False,
                  input_norm: Optional[tuple] = None) -> torch.Tensor:
    """``[B, N, SL, H, W, 3]`` → PRE-ReLU ``[B, N, ls, ls, D]`` (f32).
    ``remat`` recomputes the backbone's activations in the backward
    (activation checkpointing) instead of keeping them; ``input_norm``
    folds the input's normalize into the stem conv (``x`` un-normalised,
    ``layers.conv3d_input_norm``)."""
    b, n, sl, h, w, c = x.shape
    x = x.reshape(b * n, sl, h, w, c)
    feat = (checkpoint.checkpoint(model.backbone, x, input_norm,
                                  use_reentrant=False)
            if remat and torch.is_grad_enabled()
            else model.backbone(x, input_norm))
    if feat.shape[1] != cfg.last_duration:
        raise ValueError(f"backbone time extent {feat.shape[1]} != "
                         f"{cfg.last_duration}")
    feat = feat.float().mean(dim=1)
    ls = cfg.last_size
    return feat.reshape(b, n, ls, ls, cfg.feature_size)


def predict(model: DPC, x: torch.Tensor, *, cfg: DPCConfig,
            train: bool = True, generator: Optional[torch.Generator] = None,
            remat: bool = False, input_norm: Optional[tuple] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pred, gt)``, both ``[B, P, ls, ls, D]``: the embeddings the score
    is computed from.  GRU dropout is drawn from ``generator`` (none
    without one); ``remat`` checkpoints the backbone; with ``input_norm``
    the frames are un-normalised and the stem conv normalises them."""
    if x.ndim != 6:
        raise ValueError("apply_dpc expects [B, num_seq, seq_len, H, W, 3] "
                         f"(6-D, channels-last); got shape {tuple(x.shape)}")
    ctx = x.shape[1] - cfg.pred_step
    feature_pre = encode_blocks(model, x, cfg, remat=remat,
                                input_norm=input_norm)
    gt = feature_pre[:, ctx:]                       # pre-ReLU
    feature = F.relu(feature_pre)                   # GRU input
    _, last_states = convgru.apply_convgru(
        model.agg, feature[:, :ctx], dropout=cfg.gru_dropout, train=train,
        generator=generator, impl=cfg.gru_impl)
    hidden = [last_states[:, li] for li in range(cfg.gru_num_layers)]
    preds = []
    for _ in range(cfg.pred_step):
        p = _predictor(model, hidden[-1])
        hidden = convgru.convgru_single_step(
            model.agg, F.relu(p), hidden, dropout=cfg.gru_dropout,
            train=train, generator=generator)
        preds.append(p)
    return torch.stack(preds, dim=1), gt


def extract_context(model: nn.Module, x: torch.Tensor, *, cfg: DPCConfig,
                    num_blocks: Optional[int] = None, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    order: str = "lc") -> torch.Tensor:
    """Run the backbone + GRU trunk of ``model`` over the first
    ``num_blocks`` blocks of ``x [B, N, SL, H, W, 3]`` and return the
    last-step dense context ``[B, ls, ls, D]`` (f32).

    ``order`` picks the activation/pool order, which differs between the
    two reference heads and does not commute: "lc" is ReLU then temporal
    mean (``eval/model_3d_lc.py:53-55``), what the classifier consumes;
    "dpc" is temporal mean then ReLU (``dpc/model_3d.py:53-56``), what the
    pretraining aggregator saw."""
    if order not in ("lc", "dpc"):
        raise ValueError(f"unknown order {order!r}")
    b, n, sl, h, w, c = x.shape
    feat = model.backbone(x.reshape(b * n, sl, h, w, c))
    if order == "lc":
        feat = F.relu(feat).float().mean(dim=1)
    else:
        feat = F.relu(feat.float().mean(dim=1))
    ls = cfg.last_size
    feature = feat.reshape(b, n, ls, ls, cfg.feature_size)
    _, last_states = convgru.apply_convgru(
        model.agg, feature[:, :num_blocks], dropout=cfg.gru_dropout,
        train=train, generator=generator, impl=cfg.gru_impl)
    return last_states[:, -1]


def apply_dpc(model: DPC, x: torch.Tensor, *, cfg: DPCConfig,
              train: bool = True, generator: Optional[torch.Generator] = None,
              input_norm: Optional[tuple] = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full DPC forward: ``(score [B·P·SQ, B·P·SQ] f32, pred, gt)``."""
    pred, gt = predict(model, x, cfg=cfg, train=train, generator=generator,
                       input_norm=input_norm)
    with torch.autocast(x.device.type, enabled=False):
        score = nce.dense_score(pred.float(), gt.float())
    return score, pred, gt
