"""The plain f32 reference of the DPC pretrain model and the LC classifier.

Written from the published architecture (TengdaHan/DPC:
``backbone/resnet_2d3d.py``, ``backbone/convrnn.py``, ``dpc/model_3d.py``,
``eval/model_3d_lc.py``) in plain PyTorch operations over a dict of
parameters named as the published model names them, so the gradients of
the reference and of a system under test are compared leaf by leaf.  It
imports nothing of the system under test.

Every convolution, linear map and score product goes through
``Precision.q`` on its operands and ``Precision.act`` on its output:
identity in f32 (the reference), rounding for the control and the witness
(``precision.py``).
Batch-norm layers take batch statistics (the pretrain model's
``track_running_stats=False``; the LC model's train mode, whose running
statistics do not enter the loss).  Each residual block is recomputed in
the backward (``torch.utils.checkpoint``), which is exact here and keeps
the reference's peak memory inside the card at the timed sizes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from benchmark.reference.precision import Precision

# (block kind per stage, blocks per stage), ``backbone/resnet_2d3d.py``
ARCH = {
    "resnet18": (("basic2d", "basic2d", "basic3d", "basic3d"), (2, 2, 2, 2)),
    "resnet34": (("basic2d", "basic2d", "basic3d", "basic3d"), (3, 4, 6, 3)),
    "resnet50": (("bottleneck2d", "bottleneck2d", "bottleneck3d",
                  "bottleneck3d"), (3, 4, 6, 3)),
}
# layer4 keeps 256 planes (``resnet_2d3d.py:222``)
PLANES = (64, 128, 256, 256)
STRIDES = (1, 2, 2, 2)
BN_EPS = 1e-5
# recompute each residual block in the backward (exact; bounds the
# reference's memory at the timed sizes)
REMAT = True


def block_specs(network: str) -> list[dict]:
    """Every residual block of the backbone, in order: its parameter prefix,
    kind, channels, stride, whether it downsamples the residual and
    whether it ends in a ReLU (all but the last block of layer4)."""
    kinds, depths = ARCH[network]
    expansion = 4 if kinds[0].startswith("bottleneck") else 1
    in_ch, out = 64, []
    for si, (kind, depth) in enumerate(zip(kinds, depths)):
        for bi in range(depth):
            stride = STRIDES[si] if bi == 0 else 1
            planes = PLANES[si]
            out.append({"prefix": f"backbone.layer{si + 1}.{bi}.",
                        "kind": kind, "in_ch": in_ch, "planes": planes,
                        "out_ch": planes * expansion, "stride": stride,
                        "downsample": bi == 0 and (
                            stride != 1 or in_ch != planes * expansion),
                        "final_relu": not (si == 3 and bi == depth - 1)})
            in_ch = planes * expansion
    return out


def feature_size(network: str) -> int:
    return block_specs(network)[-1]["out_ch"]


def _kernel(kind: str, stride: int):
    """(kernel, stride, padding) of a block's spatial conv."""
    if kind.endswith("2d"):
        return (1, 3, 3), (1, stride, stride), (0, 1, 1)
    return (3, 3, 3), (stride,) * 3, (1, 1, 1)


def param_shapes(cfg: dict, job: str) -> dict[str, tuple]:
    """Name → shape of every trainable parameter of the pretrain model
    (``job='pretrain'``) or the LC classifier (``'finetune'``)."""
    shapes = {"backbone.conv1.weight": (64, 3, 1, 7, 7),
              "backbone.bn1.weight": (64,), "backbone.bn1.bias": (64,)}
    for s in block_specs(cfg["network"]):
        p, k = s["prefix"], s["kind"]
        kern, _, _ = _kernel(k, 1)
        if k.startswith("bottleneck"):
            convs = [(s["planes"], s["in_ch"], (1, 1, 1)),
                     (s["planes"], s["planes"], kern),
                     (s["out_ch"], s["planes"], (1, 1, 1))]
        else:
            convs = [(s["planes"], s["in_ch"], kern),
                     (s["planes"], s["planes"], kern)]
        for i, (co, ci, kk) in enumerate(convs, start=1):
            shapes[f"{p}conv{i}.weight"] = (co, ci, *kk)
            shapes[f"{p}bn{i}.weight"] = (co,)
            shapes[f"{p}bn{i}.bias"] = (co,)
        if s["downsample"]:
            shapes[f"{p}downsample.0.weight"] = (s["out_ch"], s["in_ch"],
                                                 1, 1, 1)
            shapes[f"{p}downsample.1.weight"] = (s["out_ch"],)
            shapes[f"{p}downsample.1.bias"] = (s["out_ch"],)
    d, k = feature_size(cfg["network"]), cfg["gru_kernel_size"]
    for li in range(cfg["gru_num_layers"]):
        for gate in ("reset_gate", "update_gate", "out_gate"):
            shapes[f"agg.cell_list.{li}.{gate}.weight"] = (d, 2 * d, k, k)
            shapes[f"agg.cell_list.{li}.{gate}.bias"] = (d,)
    if job == "pretrain":
        for i in (0, 2):
            shapes[f"network_pred.{i}.weight"] = (d, d, 1, 1)
            shapes[f"network_pred.{i}.bias"] = (d,)
    else:
        classes = cfg["finetune"]["num_classes"]
        shapes["final_bn.weight"] = (d,)
        shapes["final_bn.bias"] = (d,)
        shapes["final_fc.1.weight"] = (classes, d)
        shapes["final_fc.1.bias"] = (classes,)
    return shapes


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def conv3d(prec: Precision, x, w, stride=1, padding=0):
    return prec.act(F.conv3d(prec.q(x), prec.q(w), None, stride, padding))


def linear(prec: Precision, x, w, b):
    """A 1×1 conv over channels-last ``x`` (``w`` [out, in, 1, 1]) or a
    linear layer (``w`` [out, in])."""
    w2 = w.reshape(w.shape[0], w.shape[1])
    return prec.act(F.linear(prec.q(x), prec.q(w2), b))


def batchnorm(x, w, b):
    """Batch statistics over every axis but the channel axis 1, the biased
    variance, eps 1e-5."""
    dims = [0, *range(2, x.dim())]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + BN_EPS) * w.view(shape) \
        + b.view(shape)


def _block(prec: Precision, p: dict, s: dict, x):
    pre, kind = s["prefix"], s["kind"]
    kern, stride, pad = _kernel(kind, s["stride"])
    _, s1, p1 = _kernel(kind, 1)
    if kind.startswith("bottleneck"):
        out = F.relu(batchnorm(conv3d(prec, x, p[pre + "conv1.weight"]),
                               p[pre + "bn1.weight"], p[pre + "bn1.bias"]))
        out = F.relu(batchnorm(conv3d(prec, out, p[pre + "conv2.weight"],
                                      stride, pad),
                               p[pre + "bn2.weight"], p[pre + "bn2.bias"]))
        out = batchnorm(conv3d(prec, out, p[pre + "conv3.weight"]),
                        p[pre + "bn3.weight"], p[pre + "bn3.bias"])
    else:
        out = F.relu(batchnorm(conv3d(prec, x, p[pre + "conv1.weight"],
                                      stride, pad),
                               p[pre + "bn1.weight"], p[pre + "bn1.bias"]))
        out = batchnorm(conv3d(prec, out, p[pre + "conv2.weight"], s1, p1),
                        p[pre + "bn2.weight"], p[pre + "bn2.bias"])
    res = x
    if s["downsample"]:
        ds = ((1, s["stride"], s["stride"]) if kind.endswith("2d")
              else (s["stride"],) * 3)
        res = batchnorm(conv3d(prec, x, p[pre + "downsample.0.weight"], ds),
                        p[pre + "downsample.1.weight"],
                        p[pre + "downsample.1.bias"])
    out = out + res
    return F.relu(out) if s["final_relu"] else out


def backbone(prec: Precision, p: dict, network: str, x):
    """``x`` [N, T, H, W, 3] (normalised frames) → PRE-ReLU features
    [N, T/4, H/32, W/32, D]."""
    h = x.permute(0, 4, 1, 2, 3).contiguous()
    h = conv3d(prec, h, p["backbone.conv1.weight"], (1, 2, 2), (0, 3, 3))
    h = F.relu(batchnorm(h, p["backbone.bn1.weight"],
                         p["backbone.bn1.bias"]))
    h = F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    for s in block_specs(network):
        if REMAT and torch.is_grad_enabled():
            h = checkpoint.checkpoint(_block, prec, p, s, h,
                                      use_reentrant=False)
        else:
            h = _block(prec, p, s, h)
    return h.permute(0, 2, 3, 4, 1)


def gru_cell(prec: Precision, p: dict, layer: int, x, h):
    """``h' = h·(1−z) + tanh(W_o [x, h·r])·z``, z and r from ``[x, h]``
    (``convrnn.py:30-34``), channels-last, 1×1 kernels."""
    pre = f"agg.cell_list.{layer}."
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(linear(prec, xh, p[pre + "update_gate.weight"],
                             p[pre + "update_gate.bias"]))
    r = torch.sigmoid(linear(prec, xh, p[pre + "reset_gate.weight"],
                             p[pre + "reset_gate.bias"]))
    o = torch.tanh(linear(prec, torch.cat([x, h * r], dim=-1),
                          p[pre + "out_gate.weight"],
                          p[pre + "out_gate.bias"]))
    return h * (1.0 - z) + o * z


def dropout_mask(shape, rate: float, gen: Optional[torch.Generator],
                 device) -> Optional[torch.Tensor]:
    """Inverted-dropout multipliers drawn from ``gen``: the same draw, in
    the same order and shape, as the system's train step makes from the
    generator the benchmark hands it, so both sides drop the same units."""
    if gen is None or rate == 0.0:
        return None
    keep = 1.0 - rate
    m = torch.empty(shape, device=device, dtype=torch.float32)
    m.bernoulli_(keep, generator=gen)
    return m.mul_(1.0 / keep)


def gru_sequence(prec: Precision, p: dict, cfg: dict, x, gen):
    """The aggregator over ``x`` [B, T, S, S, C]: every layer's mask
    ``[T, B·S·S, C]`` is drawn before its recurrence.  Returns the last
    layer's states [B, T, S, S, C] and each layer's last state."""
    if cfg["gru_kernel_size"] != 1:
        raise ValueError("the reference's ConvGRU takes 1x1 kernels")
    b, t, s, _, c = x.shape
    last, cur = [], x
    for li in range(cfg["gru_num_layers"]):
        m = dropout_mask((t, b * s * s, c), cfg["gru_dropout"], gen, x.device)
        h = x.new_zeros((b, s, s, c))
        outs = []
        for i in range(t):
            h = gru_cell(prec, p, li, cur[:, i], h)
            if m is not None:
                h = h * m[i].reshape(b, s, s, c)
            outs.append(h)
        cur = torch.stack(outs, dim=1)
        last.append(h)
    return cur, last


def features(prec: Precision, p: dict, cfg: dict, x):
    """[B, N, SL, H, W, 3] → block features [B, N, S, S, D] before the
    temporal mean's ReLU, and the backbone output."""
    b, n = x.shape[:2]
    f = backbone(prec, p, cfg["network"], x.reshape(b * n, *x.shape[2:]))
    return f, b, n


def dpc_forward(prec: Precision, p: dict, cfg: dict, x, gen):
    """DPC (``dpc/model_3d.py:46-74``): ``(pred, gt)`` [B, P, S, S, D].
    The GT is the PRE-ReLU temporal mean; the aggregator reads its ReLU;
    the rollout scores the raw predictions and feeds their ReLU back."""
    f, b, n = features(prec, p, cfg, x)
    s, d = f.shape[2], f.shape[-1]
    feat = f.mean(dim=1).reshape(b, n, s, s, d)
    ctx = n - cfg["pred_step"]
    gt = feat[:, ctx:]
    _, hidden = gru_sequence(prec, p, cfg, F.relu(feat[:, :ctx]), gen)
    preds = []
    for _ in range(cfg["pred_step"]):
        h = hidden[-1]
        q = linear(prec, F.relu(linear(prec, h, p["network_pred.0.weight"],
                                       p["network_pred.0.bias"])),
                   p["network_pred.2.weight"], p["network_pred.2.bias"])
        preds.append(q)
        if len(preds) == cfg["pred_step"]:
            break  # the last rollout step's state feeds nothing
        new, inp = [], F.relu(q)
        for li in range(cfg["gru_num_layers"]):
            hl = gru_cell(prec, p, li, inp, hidden[li])
            m = dropout_mask(hl.shape, cfg["gru_dropout"], gen, hl.device)
            hl = hl if m is None else hl * m
            new.append(hl)
            inp = hl
        hidden = new
    return torch.stack(preds, dim=1), gt


def lc_forward(prec: Precision, p: dict, cfg: dict, x, gen):
    """LC (``eval/model_3d_lc.py:47-73``): ReLU, temporal mean, the
    aggregator over every block, the last state's spatial mean, BN1d,
    dropout and the linear head.  Returns logits [B, classes]."""
    f, b, n = features(prec, p, cfg, x)
    s, d = f.shape[2], f.shape[-1]
    feat = F.relu(f).mean(dim=1).reshape(b, n, s, s, d)
    out, _ = gru_sequence(prec, p, cfg, feat, gen)
    context = out[:, -1].mean(dim=(1, 2))
    normed = batchnorm(context, p["final_bn.weight"], p["final_bn.bias"])
    m = dropout_mask(normed.shape, cfg["finetune"]["dropout"], gen,
                     normed.device)
    normed = normed if m is None else normed * m
    return linear(prec, normed, p["final_fc.1.weight"], p["final_fc.1.bias"])


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def topk_hits(score, targets, ks=(1, 3, 5)) -> dict:
    """Share of rows whose target ranks in the top k columns."""
    kmax = min(max(ks), score.shape[-1])
    idx = score.topk(kmax, dim=-1).indices
    hit = idx == targets[:, None]
    return {f"top{k}": float(hit[:, :min(k, kmax)].any(-1).float().mean())
            for k in ks}


def nce_loss(prec: Precision, pred, gt, half: bool = False):
    """Dense InfoNCE (``dpc/model_3d.py:76-96``): every predicted cell
    against every GT cell of the batch, the positive on the diagonal.
    ``half``: the mean over the first half of the rows alone (a fault the
    correctness check must catch)."""
    d = pred.shape[-1]
    rows, cols = pred.reshape(-1, d), gt.reshape(-1, d)
    score = prec.act(prec.q(rows) @ prec.q(cols).t())
    t = torch.arange(score.shape[0], device=score.device)
    per_row = torch.logsumexp(score, dim=-1) - score.diagonal()
    if half:
        score, t, per_row = (x[:len(x) // 2] for x in (score, t, per_row))
    return per_row.mean(), topk_hits(score.detach(), t)


def xent_loss(logits, labels):
    loss = F.cross_entropy(logits, labels)
    return loss, topk_hits(logits.detach(), labels, (1, 5))

