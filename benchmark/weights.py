"""The weights of a run, made on the device from the seed in a few large
draws: one normal draw for every 3-D convolution (kaiming normal, fan out,
``backbone/resnet_2d3d.py:226``), one for every matrix that is initialised
orthogonal (the ConvGRU gates, the predictor and the LC head,
``convrnn.py:17-22``, ``dpc/model_3d.py:100-106``,
``eval/model_3d_lc.py:67-73``), each then made orthogonal by a QR on the
device; batch-norm scales one, biases zero.  Both the system and the
reference are given these weights."""

from __future__ import annotations

import math

import torch

from benchmark.feed import fold
from benchmark.reference.model import param_shapes


def make_weights(cfg: dict, job: str, seed: int, device) -> dict:
    shapes = param_shapes(cfg, job)
    gen = torch.Generator(device=device).manual_seed(fold(seed, "weights"))
    out = {}
    convs = [k for k, s in shapes.items() if len(s) == 5]
    mats = [k for k, s in shapes.items() if len(s) in (2, 4)]
    sizes = [math.prod(shapes[k]) for k in convs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    for k, part in zip(convs, flat.split(sizes)):
        s = shapes[k]
        fan_out = s[0] * math.prod(s[2:])
        out[k] = part.view(s) * math.sqrt(2.0 / fan_out)
    sizes = [math.prod(shapes[k]) for k in mats]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    for k, part in zip(mats, flat.split(sizes)):
        s = shapes[k]
        a = part.view(s[0], -1)
        tall = a.shape[0] >= a.shape[1]
        q, r = torch.linalg.qr(a if tall else a.t())
        q = q * torch.sign(torch.diagonal(r))
        out[k] = (q if tall else q.t()).contiguous().view(s)
    for k, s in shapes.items():
        if k not in out:  # BN scales, biases
            one = k.endswith(".weight")
            out[k] = (torch.ones if one else torch.zeros)(s, device=device)
    return {k: out[k] for k in shapes}
