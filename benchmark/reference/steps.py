"""The reference's first training steps: what the system's train step
computes over the same inputs, in plain PyTorch.

One step is, for each shard of the global batch (a rank's rows, with its
own batch statistics and, for pretraining, its own candidate pool): the
device recipe on the shard's uint8 windows with the step's draws, the
forward, the loss, the backward; then the mean of the shards' gradients
and the Adam update (coupled L2 decay, ``torch.optim.Adam``'s arithmetic;
the finetune trunk at ``lr·backbone_lr_scale``).  The loss and top-k
readings are the shards' means, as the system averages its metrics over
the ranks.

``fault`` plants one of the faults the correctness check must catch, in
the reference put in the system's place: ``frozen`` (the update leaves the
parameters as they were), ``half`` (half of the batch left out, the mean
taken over the rest), ``exchange`` (no mean across shards: the first
shard's gradient alone updates the parameters, and its metrics are
reported), ``answer`` (each reported loss altered by 1%).
"""

from __future__ import annotations

import statistics
from typing import Optional

import torch

from benchmark.reference import model as M
from benchmark.reference import recipe as R
from benchmark.reference.precision import Precision, exact_f32

FAULTS = ("frozen", "half", "half_loss", "exchange", "answer")
BETAS = (0.9, 0.999)
EPS = 1e-8


def _lrs(cfg: dict, job: str, names) -> dict[str, float]:
    if job == "pretrain":
        return {n: cfg["lr"] for n in names}
    ft = cfg["finetune"]
    trunk = ft["lr"] * ft["backbone_lr_scale"]
    return {n: trunk if n.startswith(("backbone.", "agg.")) else ft["lr"]
            for n in names}


def _shard_step(prec: Precision, cfg: dict, job: str, p: dict, clips,
                labels, seeds, device, fault):
    """Forward and backward of one shard; returns (loss, topk, recipe
    output, embeddings) with the gradients accumulated on ``p``."""
    drop_seed, aug_seed = seeds
    aug = torch.Generator().manual_seed(aug_seed)
    b, n, sl, h, w, _ = clips.shape
    if job == "pretrain":
        draws = R.draw_pretrain(aug, b, n * sl, h, w)
        x = R.pretrain(clips, draws, cfg["img_dim"])
    else:
        draws = R.draw_finetune(aug, b, h, w)
        x = R.finetune(clips, draws, cfg["img_dim"])
    x = prec.recipe(x)
    drop = torch.Generator(device=device).manual_seed(drop_seed)
    rows = x if fault != "half" else x[:b // 2]
    if job == "pretrain":
        pred, gt = M.dpc_forward(prec, p, cfg, rows, drop)
        loss, topk = M.nce_loss(prec, pred, gt, fault == "half_loss")
        embed = {"pred": pred.detach(), "gt": gt.detach()}
    else:
        lab = labels if fault != "half" else labels[:b // 2]
        logits = M.lc_forward(prec, p, cfg, rows, drop)
        if fault == "half_loss":
            loss, topk = M.xent_loss(logits[:b // 2], lab[:b // 2].long())
        else:
            loss, topk = M.xent_loss(logits, lab.long())
        embed = {"logits": logits.detach()}
    loss.backward()
    return float(loss.detach()), topk, x.detach(), embed


def run(cfg: dict, job: str, weights: dict, inputs: list, seeds: list,
        device, precision: str = "float32", fault: Optional[str] = None
        ) -> dict:
    """Three (or ``len(inputs)``) steps from ``weights``.

    ``inputs[s][k]`` is ``(uint8 clips, labels or None)`` of shard ``k`` at
    step ``s`` on ``device``; ``seeds[s][k]`` its ``(dropout, recipe)``
    seeds.  Returns the readings the check compares: each step's loss and
    top-k, the first step's gradient per leaf (the gradient Adam gets,
    decay included), each leaf's change over the steps, the first step's
    recipe output of shard 0 and embeddings (or logits) of every shard."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    prec = Precision(precision)
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in weights.items()}
    p0 = {k: v.detach().clone() for k, v in p.items()}
    lr = _lrs(cfg, job, p)
    wd = cfg["wd"] if job == "pretrain" else cfg["finetune"]["wd"]
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"loss": [], "topk": []}
    with exact_f32():
        for s, (step_inputs, step_seeds) in enumerate(zip(inputs, seeds)):
            for t in p.values():
                t.grad = None
            shards = list(zip(step_inputs, step_seeds))
            if fault == "exchange":
                shards = shards[:1]
            losses, topks = [], []
            for k, ((clips, labels), sd) in enumerate(shards):
                loss, topk, x, embed = _shard_step(prec, cfg, job, p, clips,
                                                   labels, sd, device, fault)
                losses.append(loss)
                topks.append(topk)
                if s == 0:
                    out.setdefault("embeds", []).append(embed)
                    if k == 0:
                        out["recipe"] = x
                del x, embed
            scale = 1.0 / len(shards)
            loss = statistics.fmean(losses)
            out["loss"].append(loss * (1.01 if fault == "answer" else 1.0))
            out["topk"].append({kk: statistics.fmean(t[kk] for t in topks)
                                for kk in topks[0]})
            with torch.no_grad():
                t_step = s + 1
                for k, t in p.items():
                    if t.grad is None:  # Adam skips a leaf with no gradient
                        continue
                    g = t.grad * scale + wd * t
                    if s == 0:
                        out.setdefault("grads", {})[k] = g.float().cpu()
                    if fault == "frozen":
                        continue
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    bc1 = 1 - BETAS[0] ** t_step
                    bc2 = 1 - BETAS[1] ** t_step
                    denom = (v2[k].sqrt() / bc2 ** 0.5).add_(EPS)
                    t.addcdiv_(m[k], denom, value=-lr[k] / bc1)
    out["delta_norms"] = {k: float((p[k].detach() - p0[k]).double().norm())
                          for k in p}
    return out
