"""The whole step's share of the card's bfloat16 peak: the model
operations of one rank's step (``benchmark.counts``) over the traced
window's time a step."""

from benchmark import counts, peaks
from benchmark.reference.model import feature_size


def read(ctx):
    cell, tr = ctx["cell"], ctx["rank0"].get("trace")
    if not tr:
        return None
    cfg, traffic = cell.config, cell.traffic
    flops = counts.train_step_flops(cfg, traffic["job"], traffic["batch"],
                                    feature_size(cfg["network"]))
    return 100.0 * flops * tr["steps"] / tr["window_s"] / peaks.BF16_FLOPS
