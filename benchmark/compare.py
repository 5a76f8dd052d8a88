"""The comparison that decides ``correct``: numbers that set what the
system's first training steps produced against the plain reference's over
the same weights, windows, labels and draws.

* ``recipe_gap``: the largest absolute difference of the first step's
  recipe output (normalised frames), first rank;
* ``embed_gap``: the relative L2 distance ‖a − r‖/‖r‖ of the first step's
  embeddings (the larger of pred's and gt's) or logits, first rank;
* ``loss_gap``: the relative difference of the first step's loss (the
  ranks' mean) from the reference's;
* ``loss_on_outputs_gap``: the relative difference of the first step's
  loss from the reference's loss over the step's own embeddings (logits)
  of every rank: the loss and its mean over the ranks, apart from the
  forward's rounding;
* ``head_grad_dist``: the relative L2 distance of the first gradient Adam
  got over the leaves outside the backbone (the aggregator, the predictor
  or the LC head);
* ``update_gap``: by the worst leaf, the gap between the norms of each
  leaf's change over the steps, ``|‖Δ‖ − ‖Δ_ref‖|``, over the larger of
  the leaf's reference norm and the median leaf's, leaving out the leaves
  whose reference gradient is under a thousandth of the median leaf's
  (they move by round-off alone).

Readings beside them, compared by no limit (PERF.md, the limits'
readings, says why): ``grad_gap``, the first gradient's norm gap by the
worst leaf as ``update_gap``; ``grad_dist``, the whole first gradient's
relative L2 distance; every step's ``loss_gaps``; the top-k gaps, against
the reference's and over the step's own outputs; the median leaves' gaps.

``limits`` (``benchmark/limits/<cell>.json``) holds the limit of each
number a cell compares.
"""

from __future__ import annotations

import math
import statistics

import torch

from benchmark.reference import model as M
from benchmark.reference.precision import Precision, exact_f32

QUIET = 1e-3


def _by_leaf(got: dict, ref: dict, keep=None) -> tuple[float, str, float]:
    """(worst gap, its leaf, median gap) over the leaves in ``keep``."""
    med = statistics.median(ref.values())
    gaps = {}
    for k, r in ref.items():
        if keep is None or k in keep:
            g = got.get(k, math.nan)
            gaps[k] = abs(g - r) / max(r, med, 1e-30)
    leaf = max(gaps, key=lambda k: math.inf if math.isnan(gaps[k])
               else gaps[k])
    worst = gaps[leaf] if not math.isnan(gaps[leaf]) else math.inf
    return worst, leaf, statistics.median(gaps.values())


def _rel(a: torch.Tensor, r: torch.Tensor) -> float:
    if a.shape != r.shape:
        return math.inf
    a, r = a.reshape(-1).double(), r.reshape(-1).double()
    return float((a - r).norm() / r.norm().clamp_min(1e-30))


def _flat(grads: dict, names) -> torch.Tensor | None:
    if not set(names) <= set(grads):
        return None
    return torch.cat([grads[k].reshape(-1) for k in names])


def _dist(got: dict, ref: dict, names) -> float:
    a = _flat(got, names)
    return math.inf if a is None else _rel(a, _flat(ref, names))


def on_outputs(job: str, embeds: list, labels: list, device
               ) -> tuple[float, dict]:
    """The reference's loss and top-k over the given first-step outputs of
    every rank, their means over the ranks (f32)."""
    losses, topks = [], []
    with exact_f32():
        for e, lab in zip(embeds, labels):
            if lab is not None and e["logits"].shape[0] != lab.shape[0]:
                return math.inf, {}
            if job == "pretrain":
                loss, topk = M.nce_loss(Precision(), e["pred"].to(device),
                                        e["gt"].to(device))
            else:
                loss, topk = M.xent_loss(e["logits"].to(device), lab.long())
            losses.append(float(loss))
            topks.append(topk)
    return statistics.fmean(losses), {
        k: statistics.fmean(t[k] for t in topks) for k in topks[0]}


def numbers(got: dict, ref: dict, job: str) -> tuple[dict, dict]:
    """``(numbers, readings)`` of a system's readings ``got`` against the
    reference's ``ref`` (``reference.steps.run``'s, with ``labels``)."""
    dev = ref["recipe"].device
    a = got["recipe"].to(dev).reshape(-1)
    r = ref["recipe"].reshape(-1)
    out = {"recipe_gap": float((a - r).abs().max()) if a.shape == r.shape
           else math.inf}
    out["embed_gap"] = max(_rel(got["embeds"][0][k].to(dev), v)
                           for k, v in ref["embeds"][0].items())
    gaps = [abs(g - r) / max(abs(r), 1e-30)
            for g, r in zip(got["loss"], ref["loss"])]
    whole = len(got["loss"]) == len(ref["loss"])
    out["loss_gap"] = gaps[0] if whole else math.inf
    loss, topk = on_outputs(job, got["embeds"], ref["labels"], dev)
    out["loss_on_outputs_gap"] = (abs(got["loss"][0] - loss) / abs(loss)
                                  if math.isfinite(loss) else math.inf)
    head = [k for k in ref["grads"] if not k.startswith("backbone.")]
    out["head_grad_dist"] = _dist(got["grads"], ref["grads"], head)
    norms = {k: float(v.double().norm()) for k, v in ref["grads"].items()}
    got_norms = {k: float(v.double().norm())
                 for k, v in got["grads"].items()}
    med = statistics.median(norms.values())
    moving = {k for k, v in norms.items() if v >= QUIET * med}
    out["update_gap"], u_leaf, u_med = _by_leaf(got["delta_norms"],
                                                ref["delta_norms"], moving)
    grad_gap, g_leaf, g_med = _by_leaf(got_norms, norms)
    readings = {
        "grad_gap": grad_gap, "grad_leaf": g_leaf, "grad_median_gap": g_med,
        "grad_dist": _dist(got["grads"], ref["grads"], list(ref["grads"])),
        "update_leaf": u_leaf, "update_median_gap": u_med,
        "quiet_leaves": sorted(set(norms) - moving),
        "loss_gaps": gaps,
        "topk_gap": max(abs(g[k] - r[k]) for g, r in
                        zip(got["topk"], ref["topk"]) for k in r),
        "topk_on_outputs_gap": max((abs(got["topk"][0][k] - v)
                                    for k, v in topk.items()),
                                   default=math.inf)}
    return out, readings


def judge(nums: dict, limits: dict) -> bool:
    """True when every limited number is finite and within its limit."""
    return all(k in nums and nums[k] <= v for k, v in limits.items())
