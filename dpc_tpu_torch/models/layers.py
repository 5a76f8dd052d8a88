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
statistics in f32.  ``batchnorm(bn, x, group)`` takes its batch statistics
over a process group instead (``--cross_replica_bn``, and the model
group of a clip-sharded pretrain or LC step): ``dpc_tpu``'s
``batchnorm(axis_name=...)``.

``fused_stem`` is ``dpc_tpu``'s reformulated stem (conv → BN → ReLU →
max-pool with the normalize deferred to the pooled resolution) in all three
BN modes, through K1's ReLU-off instance and K2 on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dpc_tpu_torch.ops import maxpool_cuda
from dpc_tpu_torch.parallel import collectives


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


def conv3d_input_norm(conv: nn.Conv3d, x: torch.Tensor, input_norm: tuple,
                      weight: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
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
    normalise-then-conv to rounding.  ``weight`` (with ``bias``) replaces
    the module's own: the fused stem passes its sign-folded weights.  The
    constants reach the card by asynchronous copies: a blocking copy would
    wait for the queued work in the middle of the forward."""
    mean, std, scale = input_norm
    mean = np.asarray(mean, np.float32)
    inv = _to_device(1.0 / (np.asarray(std, np.float32) * np.float32(scale)),
                     x.device)
    if conv.kernel_size[0] != 1 or conv.padding[0] != 0:
        raise ValueError("the input-norm fold needs a temporally local, "
                         "temporally unpadded stem conv")
    if weight is None:
        weight, bias = conv.weight, conv.bias
    w = weight * inv.view(1, -1, 1, 1, 1)
    if not x.is_floating_point():
        x = x.to(compute_dtype(x.device))
    y = F.conv3d(x, w, bias, conv.stride, conv.padding)
    # the correction is constant along T: one frame of the mean field
    field = _to_device(mean * np.float32(scale), x.device)
    field = field.view(1, -1, 1, 1, 1).expand(1, len(mean), 1, *x.shape[-2:])
    with torch.autocast(x.device.type, enabled=False):
        corr = F.conv3d(field, w.float(), None, conv.stride, conv.padding)
    # subtracted from y's [N·T, H·W·C] channels-last rows, so the backward
    # sums y's gradient over one leading axis (summing it over N and T of
    # the NCDHW view took 15 ms a step at the pretrain flagship)
    n, ch, t, hh, ww = y.shape
    rows = y.permute(0, 2, 3, 4, 1).reshape(n * t, hh * ww * ch)
    corr = corr.to(y.dtype).permute(0, 2, 3, 4, 1).reshape(1, -1)
    return (rows - corr).view(n, t, hh, ww, ch).permute(0, 4, 1, 2, 3)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


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


def batchnorm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
              group=None) -> torch.Tensor:
    """``bn(x)``, or with its batch statistics over the ranks of ``group``
    (None: this rank's batch, the module itself).  Over a group it is
    ``dpc_tpu/models/layers.py:181-203``, over every axis but the channel
    axis 1 whatever the rank of ``x`` (the backbone's 5-D activations, the
    LC head's ``[B, D]`` features): the mean is ``pmean``'d, the variance
    is the two-pass variance about that group mean, ``pmean``'d (every
    rank holds as many elements), normalised in f32 and cast back to
    ``x``'s dtype; with running statistics in train mode, their update
    takes the unbiased variance over the global count.  Eval mode with
    running statistics is ``bn(x)``: there are no batch statistics to
    share."""
    if group is None or (bn.track_running_stats and not bn.training):
        return bn(x)
    xf = x.float()
    dims = [0, *range(2, x.dim())]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = collectives.pmean(xf.mean(dim=dims), group)
    centred = xf - mean.view(shape)
    var = collectives.pmean(centred.square().mean(dim=dims), group)
    if bn.track_running_stats:
        _ema_update(bn, mean, var, _count(x, group))
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    y = centred * inv.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype).contiguous(memory_format=(
        torch.channels_last_3d
        if x.dim() == 5
        and x.is_contiguous(memory_format=torch.channels_last_3d)
        and not x.is_contiguous() else torch.contiguous_format))


def _count(x: torch.Tensor, group) -> int:
    """The elements behind each channel's batch statistics: this rank's
    ``x`` over every axis but axis 1, times the group's ranks (the global
    count of the unbiased variance, ``dpc_tpu``'s ``_batch_stats``)."""
    return x.numel() // x.shape[1] * collectives.size(group)


@torch.no_grad()
def _ema_update(bn: nn.modules.batchnorm._BatchNorm, mean: torch.Tensor,
                var: torch.Tensor, count: int) -> None:
    """The running statistics' EMA with torch's unbiased variance over
    ``count`` elements, and ``num_batches_tracked`` advanced, as ``bn(x)``
    does in train mode (``dpc_tpu/models/layers.py:206 _ema_update``).
    Shared by ``batchnorm`` and ``fused_stem``."""
    m = bn.momentum
    bn.running_mean.mul_(1 - m).add_(m * mean)
    bn.running_var.mul_(1 - m).add_(m * var * (count / max(count - 1, 1)))
    bn.num_batches_tracked.add_(1)


@torch.no_grad()
def _batch_stats(x: torch.Tensor, group=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 batch mean and biased variance of ``x`` over every axis but axis
    1, over the ranks of ``group`` (None: this rank's batch): the
    statistics of ``dpc_tpu``'s ``_batch_stats`` (``layers.py:181``) to f32
    rounding.  On the card one Welford pass (``torch.batch_norm_stats``, as
    the native BN takes them), with no f32 copy of ``x``; on the CPU two
    passes in f32.  Over a group, each rank's ``(mean, var)`` combine about
    the group mean (two all-reduces): ``var = pmean(var_r + (mean_r −
    mean)²)``, the two-pass variance about the group mean."""
    dims = [0, *range(2, x.dim())]
    if x.is_cuda:
        mean, invstd = torch.batch_norm_stats(x, 0.0)
        # invstd is 0 for a constant channel
        var = torch.where(invstd > 0, invstd.reciprocal().square(),
                          torch.zeros_like(invstd))
    else:
        xf = x.float()
        mean = xf.mean(dim=dims)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        var = (xf - mean.view(shape)).square().mean(dim=dims)
    if group is not None:
        mean_g = collectives.mean_(mean.clone(), group)
        var = collectives.mean_(var + (mean - mean_g).square(), group)
        mean = mean_g
    return mean, var


def _stats_backward(dz: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                    dmean: torch.Tensor, dvar: torch.Tensor,
                    count: int) -> torch.Tensor:
    """``dz + dmean/count + 2·dvar·(x − mean)/count``, the gradient of
    ``_batch_stats`` added to ``dz`` (``dz``'s dtype; ``dmean``, ``dvar``
    already summed over the group).  On the card one pass of
    ``torch.batch_norm_backward_elemt`` (unit scale, sums of −dmean and
    −2·dvar); on the CPU in f32."""
    if x.is_cuda:
        ones = torch.ones_like(mean)
        n = torch.full((1,), count, dtype=torch.int32, device=x.device)
        return torch.batch_norm_backward_elemt(dz, x, mean, ones, ones,
                                               -dmean, -2 * dvar, n)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    m, d, v = (t.view(shape) for t in (mean, dmean / count,
                                        2 * dvar / count))
    return (dz.float() + d + v * (x.float() - m)).to(dz.dtype)


def _m_h_w_c(x: torch.Tensor, strict: bool = True) -> torch.Tensor:
    """NCDHW ``x`` as the pool kernels' ``[N·D, H, W, C]``: a view of the
    channels-last-3d activation the card makes (anything else raises
    there, or with ``strict=False`` is copied)."""
    if strict and x.is_cuda and not x.is_contiguous(
            memory_format=torch.channels_last_3d):
        raise ValueError(f"the stem pool kernels take a channels_last_3d "
                         f"activation; got strides {x.stride()}")
    n, c, t, h, w = x.shape
    return x.permute(0, 2, 3, 4, 1).reshape(n * t, h, w, c).contiguous()


def _ncdhw(y4: torch.Tensor, n: int) -> torch.Tensor:
    m, h, w, c = y4.shape
    return y4.view(n, m // n, h, w, c).permute(0, 4, 1, 2, 3)


class _PoolWithStats(torch.autograd.Function):
    """``(maxpool(x'), mean, var)`` of the sign-folded conv output x'
    (NCDHW): K1's ReLU-off instance and ``_batch_stats``.  Saves x' (as the
    native BN saves its input), the f32 mean and K1's code; the backward
    runs K2 and adds the statistics' gradient to its output
    (``_stats_backward``), so no f32 copy of x' is ever kept."""

    @staticmethod
    def forward(ctx, xs, group):
        mean, var = _batch_stats(xs, group)
        pooled, code = maxpool_cuda.maxpool_fwd(_m_h_w_c(xs))
        ctx.save_for_backward(xs, mean, code)
        ctx.group, ctx.count = group, _count(xs, group)
        return _ncdhw(pooled, xs.shape[0]), mean, var

    @staticmethod
    def backward(ctx, dpooled, dmean, dvar):
        xs, mean, code = ctx.saved_tensors
        dz = maxpool_cuda.maxpool_relu_bwd(
            _m_h_w_c(dpooled, strict=False), code)
        dz = _ncdhw(dz, xs.shape[0])
        if ctx.group is not None:
            # pmean's transpose: every rank's cotangent of the shared stats
            d = collectives.sum_(torch.stack([dmean, dvar]), ctx.group)
            dmean, dvar = d[0], d[1]
        return _stats_backward(dz, xs, mean, dmean, dvar, ctx.count), None


class _PooledAffineRelu(torch.autograd.Function):
    """``relu(P·a + b)`` of NCDHW ``P`` with per-channel f32 ``a``, ``b``,
    computed in f32 and returned in P's dtype and layout.  On the card each
    direction is one elementwise pass and one reduction of ATen's
    batch-norm primitives (``batch_norm_elemt``, ``batch_norm_backward_
    reduce``) at the pooled resolution; on the CPU plain f32 math."""

    @staticmethod
    def forward(ctx, p, a, b):
        if p.is_cuda:
            zero, one = torch.zeros_like(a), torch.ones_like(a)
            y = torch.batch_norm_elemt(p, a, b, zero, one, 0.0).relu_()
        else:
            shape = (1, -1, 1, 1, 1)
            y = torch.relu(p.float() * a.view(shape)
                           + b.view(shape)).to(p.dtype)
        ctx.save_for_backward(p, a, y)
        return y

    @staticmethod
    def backward(ctx, g):
        p, a, y = ctx.saved_tensors
        g = torch.ops.aten.threshold_backward(g, y, 0)
        if p.is_cuda:
            zero, one = torch.zeros_like(a), torch.ones_like(a)
            _, _, da, db = torch.batch_norm_backward_reduce(
                g, p, zero, one, a, False, True, True)
            dp = torch.batch_norm_elemt(g, a, zero, zero, one, 0.0)
            return dp, da, db
        dims, shape = (0, 2, 3, 4), (1, -1, 1, 1, 1)
        gf = g.float()
        return ((gf * a.view(shape)).to(p.dtype),
                (gf * p.float()).sum(dim=dims), gf.sum(dim=dims))


def fused_stem(conv: nn.Conv3d, bn: nn.modules.batchnorm._BatchNorm,
               x: torch.Tensor, *, input_norm: Optional[tuple] = None,
               group=None) -> torch.Tensor:
    """conv → BN → ReLU → 3×3/s2/p1 max-pool of NCDHW ``x`` with the
    normalize deferred to the pooled resolution: the port of ``dpc_tpu``'s
    ``fused_stem`` (``dpc_tpu/models/layers.py:482``), equal to the literal
    order to rounding.

    With s = +1 where γ ≥ 0 and −1 elsewhere (never 0, no gradient), the
    conv runs on s-folded weights (and bias) and emits x' = s·conv(x); the
    pool of x' (K1's ReLU-off instance, first-max routing; K2 backward)
    commutes with the per-channel monotone map ``relu(a⁺·x' + b)``,
    a⁺ = s·γ·rsqrt(var + ε) ≥ 0 (its ∂/∂γ = s·rsqrt(var + ε) stays live
    at γ = 0), b = β − s·mean(x')·γ·rsqrt(var + ε).  The BN modes are
    ``batchnorm``'s: batch statistics (``_batch_stats``, over ``group``'s
    ranks when given) without running statistics (pretrain); with them in
    train mode (LC train) the same, and the EMA of the true mean
    s·mean(x') and the unbiased variance over the global count
    (``_ema_update``, ``num_batches_tracked`` too); in eval mode the
    running statistics, as constants.  ``input_norm`` folds the input's
    normalize into the s-folded conv (``conv3d_input_norm``).  Returns the
    pooled activation in the conv's dtype, channels-last-3d on the card."""
    gamma = bn.weight
    sgn = torch.where(gamma.detach() >= 0, 1.0, -1.0)
    w = conv.weight * sgn.view(-1, 1, 1, 1, 1)
    bias = None if conv.bias is None else conv.bias * sgn
    xs = (F.conv3d(x, w, bias, conv.stride, conv.padding)
          if input_norm is None
          else conv3d_input_norm(conv, x, input_norm, weight=w, bias=bias))
    if bn.track_running_stats and not bn.training:
        pooled = maxpool_cuda.maxpool_3x3s2(
            xs.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
        mean, var = bn.running_mean, bn.running_var
    else:
        pooled, mean_p, var = _PoolWithStats.apply(xs, group)
        mean = sgn * mean_p
        if bn.track_running_stats:
            _ema_update(bn, mean.detach(), var.detach(), _count(xs, group))
    inv = torch.rsqrt(var + bn.eps)
    a_pos = sgn * gamma * inv
    b = bn.bias - mean * (gamma * inv)
    return _PooledAffineRelu.apply(pooled, a_pos, b)


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
    (reference ``backbone/resnet_2d3d.py:214``).

    ``impl`` (the switch of ``dpc_tpu``'s ``relu_maxpool_stem``):
      * "xla": ``F.max_pool3d(F.relu(x))``; ties route the gradient to the
        first max, as in the reference;
      * "sas": the same call.  ``dpc_tpu``'s "sas" is XLA's
        SelectAndScatter, first-max routing gated by x > 0, which is what
        ATen's max-pool autograd after the ReLU computes;
      * "pallas": the CUDA kernels K1/K2 (``ops/maxpool_cuda.py``), first-max
        routing; the name is kept for switch parity;
      * "eqroute" (even H and W): K1's forward and K8's equality-routed
        backward gated by x > 0 (``maxpool_cuda.relu_maxpool_3x3s2_eq``),
        which gives every tied maximum the window's gradient and saves x;
      * "auto": "pallas" for a CUDA tensor, "xla" for a CPU tensor.
    "pallas" and "eqroute" take the channels-last-3d activation the backbone
    makes on the card (anything else raises); a CPU tensor runs the
    kernels' plain versions.
    """
    if impl == "auto":
        impl = "pallas" if x.is_cuda else "xla"
    if impl in ("xla", "sas"):
        return F.max_pool3d(F.relu(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    if impl in ("pallas", "eqroute"):
        if x.is_cuda and not x.is_contiguous(
                memory_format=torch.channels_last_3d):
            raise ValueError(f"the stem pool kernel takes a channels_last_3d "
                             f"activation; got strides {x.stride()}")
        pool = (maxpool_cuda.relu_maxpool_3x3s2 if impl == "pallas"
                else maxpool_cuda.relu_maxpool_3x3s2_eq)
        return pool(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
    raise ValueError(f"unknown stem pool impl {impl!r} "
                     "(expected auto | xla | sas | pallas | eqroute)")
