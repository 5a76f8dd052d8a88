"""2D-3D ResNet backbone family (18/34/50/101/152/200).

Port of ``dpc_tpu/models/resnet2d3d.py`` (reference
``backbone/resnet_2d3d.py``): stages 1-2 use "2D" blocks (1×3×3 kernels,
spatial stride only), stages 3-4 true 3D blocks (3×3×3, stride in time
too), the stem never strides time, layer4 keeps 256 planes, and the last
block of layer4 skips its final ReLU so the DPC head reads a
pre-activation embedding.

``stem_impl`` switches the stem as ``dpc_tpu``'s ``apply_resnet2d3d``
does: "unfused" is the literal conv → BN → ReLU → max-pool, whose pool runs
``layers.relu_maxpool_stem`` with ``stem_pool_impl`` ("auto": the CUDA
kernels on the card); "fused" is ``layers.fused_stem`` (the normalize
deferred to the pooled resolution, K1's ReLU-off instance and K2);
"auto" is "unfused" for a CPU tensor, as ``dpc_tpu`` off the TPU, and on
the card ``STEM_AUTO_CUDA`` ("fused").  ``input_norm``
folds the input's normalize into the stem conv
(``layers.conv3d_input_norm``, the ``--fold_normalize`` of
``--device_augment``).  ``bn_group`` takes every BN's batch statistics
over a process group (``layers.batchnorm``; ``dpc_tpu``'s ``axis_name``),
None this rank's batch.  ``track_running_stats=True`` builds the LC
classifier's backbone (``eval/model_3d_lc.py:26-28``).  Module names are the
reference's (``conv1``, ``bn1``, ``layerL.B.{conv,bn}{i}``,
``layerL.B.downsample.{0,1}``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dpc_tpu_torch.models import layers as L
from dpc_tpu_torch.utils import profiling

# (block kinds per stage, blocks per stage)
ARCH: dict[str, tuple[tuple[str, str, str, str], tuple[int, int, int, int]]] = {
    "resnet18": (("basic2d", "basic2d", "basic3d", "basic3d"), (2, 2, 2, 2)),
    "resnet34": (("basic2d", "basic2d", "basic3d", "basic3d"), (3, 4, 6, 3)),
    "resnet50": (("bottleneck2d", "bottleneck2d", "bottleneck3d",
                  "bottleneck3d"), (3, 4, 6, 3)),
    "resnet101": (("bottleneck2d", "bottleneck2d", "bottleneck3d",
                   "bottleneck3d"), (3, 4, 23, 3)),
    "resnet152": (("bottleneck2d", "bottleneck2d", "bottleneck3d",
                   "bottleneck3d"), (3, 8, 36, 3)),
    "resnet200": (("bottleneck2d", "bottleneck2d", "bottleneck3d",
                   "bottleneck3d"), (3, 24, 36, 3)),
}
# layer4 planes deliberately 256, not 512 (reference :222)
STAGE_PLANES = (64, 128, 256, 256)
STAGE_STRIDES = (1, 2, 2, 2)
EXPANSION = {"basic2d": 1, "basic3d": 1, "bottleneck2d": 4, "bottleneck3d": 4}


STEM_IMPLS = ("auto", "fused", "unfused")
# What stem_impl="auto" runs on the card, in every BN mode.  Timed in turns
# with the literal stem on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5
# and §6, the fused stem's entry; chip_smoke.py phases 3-4), the fused
# stem was faster in each mode: the pretrain flagship step (batch
# statistics) by 3.3%, the LC finetune step (EMA) by 2.9%, its eval step
# (running statistics) by 3.5% and the dense-test forward by 3.6%.
STEM_AUTO_CUDA = "fused"


def resolve_stem_impl(impl: str, x: torch.Tensor) -> str:
    """``impl`` with "auto" resolved for the stem input ``x``: "unfused" on
    the CPU, ``STEM_AUTO_CUDA`` on the card."""
    if impl not in STEM_IMPLS:
        raise ValueError(f"unknown stem_impl {impl!r} "
                         "(expected auto | fused | unfused)")
    if impl != "auto":
        return impl
    return STEM_AUTO_CUDA if x.is_cuda else "unfused"


def _block_specs(network: str) -> list[list[dict]]:
    """Static per-block spec table: kind / channels / stride / final-relu."""
    kinds, depths = ARCH[network]
    in_ch = 64
    stages = []
    for si, (kind, depth) in enumerate(zip(kinds, depths)):
        planes = STAGE_PLANES[si]
        stride = STAGE_STRIDES[si]
        is_final_stage = si == 3
        blocks = []
        for bi in range(depth):
            s = stride if bi == 0 else 1
            out_ch = planes * EXPANSION[kind]
            blocks.append({
                "kind": kind,
                "in_ch": in_ch,
                "planes": planes,
                "stride": s,
                "downsample": bi == 0 and (s != 1 or in_ch != out_ch),
                # only the LAST block of layer4 drops its final ReLU
                "final_relu": not (is_final_stage and bi == depth - 1),
            })
            in_ch = out_ch
        stages.append(blocks)
    return stages


def feature_size(network: str) -> int:
    kinds, _ = ARCH[network]
    return STAGE_PLANES[3] * EXPANSION[kinds[3]]


def _conv_shape(kind: str, stride: int):
    """(kernel, stride, padding) of the spatial conv inside a block."""
    if kind.endswith("2d"):
        return (1, 3, 3), (1, stride, stride), (0, 1, 1)
    return (3, 3, 3), (stride, stride, stride), (1, 1, 1)


def _down_stride(kind: str, stride: int) -> tuple[int, int, int]:
    return (1, stride, stride) if kind.endswith("2d") else (stride,) * 3


class Block(nn.Module):
    """BasicBlock or Bottleneck, 2D or 3D, as the spec says."""

    def __init__(self, spec: dict, track_running_stats: bool = False):
        super().__init__()
        bn = lambda ch: L.batchnorm3d(ch, track_running_stats)
        kind, in_ch, planes, stride = (spec["kind"], spec["in_ch"],
                                       spec["planes"], spec["stride"])
        self.final_relu = spec["final_relu"]
        self.bottleneck = kind.startswith("bottleneck")
        k, st, pad = _conv_shape(kind, stride)
        if self.bottleneck:
            out_ch = planes * 4
            self.conv1 = L.conv3d(in_ch, planes, 1)
            self.bn1 = bn(planes)
            self.conv2 = L.conv3d(planes, planes, k, st, pad)
            self.bn2 = bn(planes)
            self.conv3 = L.conv3d(planes, out_ch, 1)
            self.bn3 = bn(out_ch)
        else:
            out_ch = planes
            self.conv1 = L.conv3d(in_ch, planes, k, st, pad)
            self.bn1 = bn(planes)
            k2, st2, pad2 = _conv_shape(kind, 1)
            self.conv2 = L.conv3d(planes, planes, k2, st2, pad2)
            self.bn2 = bn(planes)
        self.downsample = None
        if spec["downsample"]:
            self.downsample = nn.Sequential(
                L.conv3d(in_ch, out_ch, 1, _down_stride(kind, stride)),
                bn(out_ch))

    def forward(self, x: torch.Tensor, bn_group=None) -> torch.Tensor:
        bn = lambda m, h: L.batchnorm(m, h, bn_group)
        out = F.relu(bn(self.bn1, self.conv1(x)))
        out = bn(self.bn2, self.conv2(out))
        if self.bottleneck:
            out = bn(self.bn3, self.conv3(F.relu(out)))
        residual = x
        if self.downsample is not None:
            conv, norm = self.downsample
            residual = bn(norm, conv(x))
        out = out + residual
        return F.relu(out) if self.final_relu else out


class ResNet2d3d(nn.Module):
    """x: NDHWC ``[B, T, H, W, 3]`` → ``[B, T/4, H/32, W/32, D]`` (pre-ReLU)."""

    def __init__(self, network: str = "resnet18",
                 track_running_stats: bool = False,
                 stem_pool_impl: str = "auto", stem_impl: str = "auto"):
        super().__init__()
        if stem_impl not in STEM_IMPLS:
            raise ValueError(f"unknown stem_impl {stem_impl!r} "
                             "(expected auto | fused | unfused)")
        self.network = network
        self.stem_pool_impl = stem_pool_impl
        self.stem_impl = stem_impl
        self.conv1 = L.conv3d(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3))
        self.bn1 = L.batchnorm3d(64, track_running_stats)
        for si, stage in enumerate(_block_specs(network)):
            setattr(self, f"layer{si + 1}", nn.Sequential(
                *[Block(spec, track_running_stats) for spec in stage]))

    def stem(self, h: torch.Tensor, input_norm: Optional[tuple] = None,
             bn_group=None) -> torch.Tensor:
        """The stem of NCDHW ``h``: conv, BN, ReLU and the 3×3/s2 max-pool,
        fused or in the literal order as ``stem_impl`` resolves
        (``stem_pool_impl`` picks the literal order's pool)."""
        impl = resolve_stem_impl(self.stem_impl, h)
        if impl == "fused":
            return L.fused_stem(self.conv1, self.bn1, h,
                                input_norm=input_norm, group=bn_group)
        h = (self.conv1(h) if input_norm is None
             else L.conv3d_input_norm(self.conv1, h, input_norm))
        return L.relu_maxpool_stem(L.batchnorm(self.bn1, h, bn_group),
                                   self.stem_pool_impl)

    def forward(self, x: torch.Tensor, input_norm: Optional[tuple] = None,
                bn_group=None) -> torch.Tensor:
        """``input_norm=(mean, std, scale)``: ``x`` is un-normalised, [0, 1]
        f32 (scale 1) or raw uint8 (scale 255), and the normalize is
        folded into the stem conv.  ``bn_group``: the process group of the
        BN statistics (None: this rank's batch)."""
        # NDHWC → NCDHW is a view with channels_last_3d strides
        with profiling.span("dpc.backbone.stem"):
            h = self.stem(x.permute(0, 4, 1, 2, 3), input_norm, bn_group)
        # the stem is the first layer: its backward is the backward's last
        # work, from this mark to the end
        h = profiling.mark_backward(h, "dpc.backbone.stem.backward")
        for si in range(4):
            for block in getattr(self, f"layer{si + 1}"):
                h = block(h, bn_group)
        return h.permute(0, 2, 3, 4, 1)
