"""The ConvGRU aggregator's share of its roofline: the least time of its
forward and backward over the blocks it reads (``counts.gru_cost``) over
its CUDA-event time at the cell's shapes."""

from benchmark import counts, peaks
from benchmark.reference.model import feature_size


def read(ctx):
    ms = ctx["rank0"].get("pieces", {}).get("convgru")
    if not ms:
        return None
    cell = ctx["cell"]
    cfg, traffic = cell.config, cell.traffic
    blocks = (cfg["num_seq"] - cfg["pred_step"] if traffic["job"] == "pretrain"
              else cfg["num_seq"])
    flops, nbytes = counts.gru_cost(cfg, traffic["batch"], blocks,
                                    feature_size(cfg["network"]))
    return 100.0 * peaks.least_seconds(flops, nbytes) / (ms / 1e3)
