"""The ConvGRU aggregator's share of its roofline inside the real step:
the least time of its forward and backward over the context blocks
(``counts.gru_cost``, as ``convgru_roofline``) over the device ms a step
launched under ``dpc.agg`` and ``dpc.agg.backward`` in the traced
window."""

from benchmark import counts, spans
from benchmark.reference.model import feature_size


def read(ctx):
    cell = ctx["cell"]
    cfg, traffic = cell.config, cell.traffic
    blocks = (cfg["num_seq"] - cfg["pred_step"] if traffic["job"] == "pretrain"
              else cfg["num_seq"])
    flops, nbytes = counts.gru_cost(cfg, traffic["batch"], blocks,
                                    feature_size(cfg["network"]))
    return spans.share_of_roofline(flops, nbytes, spans.device_ms(
        ctx, "dpc.agg", "dpc.agg.backward"))
