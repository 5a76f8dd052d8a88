"""The stem's share of its roofline: the least time of its forward and
backward (conv, BN, ReLU, pool; ``counts.stem_cost``) over the CUDA-event
time of the stem as the backbone calls it, at the cell's shapes."""

from benchmark import counts, peaks


def read(ctx):
    ms = ctx["rank0"].get("pieces", {}).get("stem")
    if not ms:
        return None
    cell = ctx["cell"]
    flops, nbytes = counts.stem_cost(cell.config, cell.traffic["batch"])
    return 100.0 * peaks.least_seconds(flops, nbytes) / (ms / 1e3)
