"""Operations and bytes of the work a cell asks for, counted from shapes.

The math is counted once, whatever implements it: a convolution or a
matrix product is 2 operations a multiply-add; elementwise work, batch
norm and pooling are not counted.  A training step is three times its
forward (the input gradient and the weight gradient of every product),
less the stem convolution's input gradient, which nothing needs, and with
no recomputation.  Bytes are each input read once and each output written
once, in the dtype the configuration moves it in.
"""

from __future__ import annotations

import math

from benchmark.reference.model import _kernel, block_specs


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(clips: int, cin: int, cout: int, kernel, out) -> float:
    return 2.0 * clips * cin * cout * math.prod(kernel) * math.prod(out)


def stem_shape(cfg: dict) -> tuple[int, int, int]:
    """(T, H, W) of the stem conv's output."""
    d = cfg["img_dim"]
    s = _out(d, 7, 2, 3)
    return cfg["seq_len"], s, s


def stem_conv_flops(cfg: dict, clips: int) -> float:
    """The stem conv's forward over ``clips`` clips of ``seq_len`` frames."""
    return _conv(clips, 3, 64, (1, 7, 7), stem_shape(cfg))


def backbone_flops(cfg: dict, clips: int) -> float:
    """Every conv of the backbone, forward, over ``clips`` blocks."""
    t, h, w = stem_shape(cfg)
    total = stem_conv_flops(cfg, clips)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # the stem's pool
    for s in block_specs(cfg["network"]):
        kern, stride, pad = _kernel(s["kind"], s["stride"])
        out = tuple(_out(n, k, st, p) for n, k, st, p in
                    zip((t, h, w), kern, stride, pad))
        k1 = _kernel(s["kind"], 1)[0]
        if s["kind"].startswith("bottleneck"):
            total += _conv(clips, s["in_ch"], s["planes"], (1, 1, 1),
                           (t, h, w))
            total += _conv(clips, s["planes"], s["planes"], kern, out)
            total += _conv(clips, s["planes"], s["out_ch"], (1, 1, 1), out)
        else:
            total += _conv(clips, s["in_ch"], s["planes"], kern, out)
            total += _conv(clips, s["planes"], s["planes"], k1, out)
        if s["downsample"]:
            total += _conv(clips, s["in_ch"], s["out_ch"], (1, 1, 1), out)
        t, h, w = out
    return total


def last_size(cfg: dict) -> int:
    return math.ceil(cfg["img_dim"] / 32)


def gru_step_flops(cfg: dict, rows: int, d: int) -> float:
    """One step of every ConvGRU layer over ``rows`` cells (1×1 gates)."""
    return 2.0 * 3 * rows * (2 * d) * d * cfg["gru_num_layers"]


def pretrain_forward(cfg: dict, batch: int, d: int) -> dict[str, float]:
    """Forward operations of the pretrain model by part, for one rank's
    ``batch`` clips with local negatives."""
    n, p = cfg["num_seq"], cfg["pred_step"]
    cells = batch * last_size(cfg) ** 2
    rows = batch * p * last_size(cfg) ** 2
    return {"backbone": backbone_flops(cfg, batch * n),
            # the context steps and the rollout's, but its last (unused)
            "convgru": gru_step_flops(cfg, cells, d) * (n - 1),
            "predictor": 2.0 * 2 * cells * d * d * p,
            "nce": 2.0 * rows * rows * d}


def finetune_forward(cfg: dict, batch: int, d: int) -> dict[str, float]:
    n = cfg["num_seq"]
    cells = batch * last_size(cfg) ** 2
    return {"backbone": backbone_flops(cfg, batch * n),
            "convgru": gru_step_flops(cfg, cells, d) * n,
            "head": 2.0 * batch * d * cfg["finetune"]["num_classes"]}


def train_step_flops(cfg: dict, job: str, batch: int, d: int) -> float:
    """A rank's train step: three times the forward, without the stem
    conv's input gradient."""
    fwd = (pretrain_forward if job == "pretrain" else finetune_forward)(
        cfg, batch, d)
    return 3.0 * sum(fwd.values()) - stem_conv_flops(cfg,
                                                     batch * cfg["num_seq"])


def act_bytes(cfg: dict) -> int:
    return 2 if cfg["compute_dtype"] == "bfloat16" else 4


def stem_cost(cfg: dict, batch: int) -> tuple[float, float]:
    """(operations, bytes) of the stem (conv, BN, ReLU, pool) forward and
    backward: the conv's forward and weight gradient; the f32 frames read
    in each direction, the pooled activation written and its gradient
    read."""
    clips = batch * cfg["num_seq"]
    t, h, w = stem_shape(cfg)
    frames = clips * cfg["seq_len"] * cfg["img_dim"] ** 2 * 3 * 4
    pooled = clips * t * _out(h, 3, 2, 1) * _out(w, 3, 2, 1) * 64 \
        * act_bytes(cfg)
    weight = 64 * 3 * 49 * 4
    return (2.0 * stem_conv_flops(cfg, clips),
            2.0 * frames + 2.0 * pooled + 2.0 * weight)


def gru_cost(cfg: dict, batch: int, steps: int, d: int
             ) -> tuple[float, float]:
    """(operations, bytes) of the aggregator's forward and backward over
    ``steps`` blocks: f32 inputs and states; the forward reads the inputs
    and weights and writes every state, the backward reads the inputs,
    states and the last state's gradient and writes the input and weight
    gradients."""
    cells = batch * last_size(cfg) ** 2
    layers = cfg["gru_num_layers"]
    x = cells * steps * d * 4
    weights = layers * 3 * (2 * d * d + d) * 4
    states = layers * x
    fwd = x + weights + states
    bwd = x + states + cells * d * 4 + x + weights
    return 3.0 * gru_step_flops(cfg, cells, d) * steps, float(fwd + bwd)


def nce_cost(cfg: dict, batch: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of the loss's forward and backward over the
    ``[R, R]`` score of one rank's local pool: the two products of the
    backward and the forward's; f32 embeddings read in each direction and
    their gradients written."""
    rows = batch * cfg["pred_step"] * last_size(cfg) ** 2
    emb = 2 * rows * d * 4
    return 6.0 * rows * rows * d, float(3 * emb)
