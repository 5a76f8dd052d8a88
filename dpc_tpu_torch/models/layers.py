"""Neural-net primitives of the port (counterpart of
``dpc_tpu/models/layers.py``).

Parameters live in ``nn.Module``s named as in the reference model, so a
reference ``state_dict`` loads without a key map.  The backbone computes in
PyTorch's NCDHW convention internally; the public model functions keep the
JAX package's channels-last layout.

BatchNorm for DPC pretraining is torch's ``track_running_stats=False``
(``dpc/model_3d.py:28``): batch statistics always, biased variance to
normalise, eps 1e-5.  The LC classifier keeps running statistics
(``eval/model_3d_lc.py:26-28``), torch's default, which is ``dpc_tpu``'s
``batchnorm(state=...)``: batch statistics in train mode with an EMA
(momentum 0.1) of the mean and the unbiased variance, running statistics in
eval mode.  Under bf16 autocast the native kernels accumulate the
statistics in f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dpc_tpu_torch.ops import maxpool_cuda


def conv3d(in_ch: int, out_ch: int, kernel, stride=1, padding=0) -> nn.Conv3d:
    """Bias-free 3-D conv with the backbone's kaiming-normal fan_out init
    (``backbone/resnet_2d3d.py:226``)."""
    conv = nn.Conv3d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     bias=False)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
    return conv


def compute_dtype(device: torch.device) -> torch.dtype:
    """The dtype a conv computes in here: autocast's when it is on."""
    if torch.is_autocast_enabled(device.type):
        return torch.get_autocast_dtype(device.type)
    return torch.float32


def conv3d_input_norm(conv: nn.Conv3d, x: torch.Tensor,
                      input_norm: tuple) -> torch.Tensor:
    """``conv((x/scale − mean)/std)`` computed from the un-normalised
    NCDHW ``x``: the per-channel normalize folded into the conv (port of
    ``dpc_tpu/models/layers.py:106``).

    With ``input_norm = (mean, std, scale)``, linearity gives
    ``conv(W/(s·σ), x) − conv(W/(s·σ), s·m·𝟙)``, 𝟙 ones inside the frame
    and zero in the padding, so the correction is the same scaled weights
    over a constant one-frame field (exact at the zero-padded borders,
    where a constant bias would not be), computed in f32.  With scale 255,
    uint8 windows feed the stem: they are cast to the compute dtype here
    (uint8 is exact in bf16), not left to autocast.  Equal to
    normalise-then-conv to rounding."""
    mean, std, scale = input_norm
    mean = np.asarray(mean, np.float32)
    inv = torch.as_tensor(1.0 / (np.asarray(std, np.float32)
                                 * np.float32(scale)), device=x.device)
    if conv.kernel_size[0] != 1 or conv.padding[0] != 0:
        raise ValueError("the input-norm fold needs a temporally local, "
                         "temporally unpadded stem conv")
    w = conv.weight * inv.view(1, -1, 1, 1, 1)
    if not x.is_floating_point():
        x = x.to(compute_dtype(x.device))
    y = F.conv3d(x, w, conv.bias, conv.stride, conv.padding)
    # the correction is constant along T: one frame of the mean field
    field = torch.as_tensor(mean * np.float32(scale), device=x.device)
    field = field.view(1, -1, 1, 1, 1).expand(1, len(mean), 1, *x.shape[-2:])
    with torch.autocast(x.device.type, enabled=False):
        corr = F.conv3d(field, w.float(), None, conv.stride, conv.padding)
    return y - corr.to(y.dtype)


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


def batchnorm3d(ch: int, track_running_stats: bool = False
                ) -> nn.BatchNorm3d:
    """BN with weight 1, bias 0: batch statistics only, or with running
    statistics (momentum 0.1, eps 1e-5)."""
    return nn.BatchNorm3d(ch, eps=1e-5, momentum=0.1,
                          track_running_stats=track_running_stats)


def linear_orthogonal(in_ch: int, out_ch: int) -> nn.Linear:
    """Linear layer with orthogonal weight and zero bias: the LC head
    (``eval/model_3d_lc.py:45,67-73``)."""
    fc = nn.Linear(in_ch, out_ch)
    nn.init.orthogonal_(fc.weight)
    nn.init.zeros_(fc.bias)
    return fc


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


def relu_maxpool_stem(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """The stem's ReLU → 3×3/s2/p1 max-pool over (H, W) of NCDHW ``x``
    (reference ``backbone/resnet_2d3d.py:214``).  Ties route the gradient
    to the first max, as in the reference.

    ``impl`` (the switch of ``dpc_tpu``'s ``relu_maxpool_stem``):
      * "xla": ``F.max_pool3d(F.relu(x))``;
      * "pallas": the CUDA kernels K1/K2 (``ops/maxpool_cuda.py``), which
        take the channels-last-3d activation the backbone makes on the card
        (anything else raises); the name is kept for switch parity;
      * "auto": "pallas" for a CUDA tensor, "xla" for a CPU tensor.
    "sas" and "eqroute" are XLA's own and are not ported.
    """
    if impl == "auto":
        impl = "pallas" if x.is_cuda else "xla"
    if impl == "xla":
        return F.max_pool3d(F.relu(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    if impl == "pallas":
        if x.is_cuda and not x.is_contiguous(
                memory_format=torch.channels_last_3d):
            raise ValueError(f"the stem pool kernel takes a channels_last_3d "
                             f"activation; got strides {x.stride()}")
        y = maxpool_cuda.relu_maxpool_3x3s2(x.permute(0, 2, 3, 4, 1))
        return y.permute(0, 4, 1, 2, 3)
    if impl in ("sas", "eqroute"):
        raise NotImplementedError(f"stem pool impl {impl!r} is XLA-specific "
                                  "and not ported to dpc_tpu_torch")
    raise ValueError(f"unknown stem pool impl {impl!r} "
                     "(expected auto | xla | pallas)")
