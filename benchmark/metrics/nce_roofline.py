"""The InfoNCE loss's share of its roofline: the least time of its forward
and backward over one rank's score (``counts.nce_cost``) over its
CUDA-event time at the cell's shapes."""

from benchmark import counts, peaks
from benchmark.reference.model import feature_size


def read(ctx):
    ms = ctx["rank0"].get("pieces", {}).get("nce")
    if not ms:
        return None
    cell = ctx["cell"]
    flops, nbytes = counts.nce_cost(cell.config, cell.traffic["batch"],
                                    feature_size(cell.config["network"]))
    return 100.0 * peaks.least_seconds(flops, nbytes) / (ms / 1e3)
