"""The InfoNCE loss's share of its roofline inside the real step: the
least time of its forward and backward over one rank's score
(``counts.nce_cost``) over the device ms a step launched under
``dpc.step.loss`` and ``dpc.nce.backward`` in the traced window."""

from benchmark import counts, spans
from benchmark.reference.model import feature_size


def read(ctx):
    cell = ctx["cell"]
    flops, nbytes = counts.nce_cost(cell.config, cell.traffic["batch"],
                                    feature_size(cell.config["network"]))
    return spans.share_of_roofline(flops, nbytes, spans.device_ms(
        ctx, "dpc.step.loss", "dpc.nce.backward"))
