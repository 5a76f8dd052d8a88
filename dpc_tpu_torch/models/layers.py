"""Neural-net primitives of the port (counterpart of
``dpc_tpu/models/layers.py``).

Parameters live in ``nn.Module``s named as in the reference model, so a
reference ``state_dict`` loads without a key map.  The backbone computes in
PyTorch's NCDHW convention internally; the public model functions keep the
JAX package's channels-last layout.

BatchNorm for DPC pretraining is torch's ``track_running_stats=False``
(``dpc/model_3d.py:28``): batch statistics always, biased variance to
normalise, eps 1e-5.  Under bf16 autocast the native kernels accumulate the
statistics in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def conv3d(in_ch: int, out_ch: int, kernel, stride=1, padding=0) -> nn.Conv3d:
    """Bias-free 3-D conv with the backbone's kaiming-normal fan_out init
    (``backbone/resnet_2d3d.py:226``)."""
    conv = nn.Conv3d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     bias=False)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
    return conv


def conv2d(in_ch: int, out_ch: int, kernel: int) -> nn.Conv2d:
    """2-D conv with bias: orthogonal weight over torch's matrix view, zero
    bias — the ConvGRU gates (``convrnn.py:17-22``) and the predictor
    (``dpc/model_3d.py:100-106``)."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)
    nn.init.orthogonal_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


def conv2d_cl(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``conv`` to channels-last ``x [..., H, W, C]``.  A 1×1 conv is
    a per-cell dense layer over the channels."""
    if conv.kernel_size == (1, 1):
        return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)
    lead = x.shape[:-3]
    y = conv(x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], y.shape[1])


def batchnorm3d(ch: int) -> nn.BatchNorm3d:
    """Batch-statistics BN (weight 1, bias 0; no running stats)."""
    return nn.BatchNorm3d(ch, eps=1e-5, track_running_stats=False)


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Inverted-dropout multipliers: 0 with probability ``rate``, else
    1/(1−rate), f32, drawn from ``generator``."""
    keep = 1.0 - rate
    m = torch.empty(shape, device=device, dtype=torch.float32)
    m.bernoulli_(keep, generator=generator)
    return m.mul_(1.0 / keep)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout (torch semantics: scale by 1/(1−p) at train time)."""
    if not train or rate == 0.0 or generator is None:
        return x
    return x * dropout_mask(x.shape, rate, generator, x.device).to(x.dtype)


def relu_maxpool_stem(x: torch.Tensor) -> torch.Tensor:
    """The stem's ReLU → 3×3/s2/p1 max-pool over (H, W) of NCDHW ``x``
    (reference ``backbone/resnet_2d3d.py:214``).  Ties route the gradient
    to the first max, as in the reference."""
    return F.max_pool3d(F.relu(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
