"""The stem's share of its roofline inside the real step: the least time
of its forward and backward (``counts.stem_cost``) over the device ms a
step launched under ``dpc.backbone.stem`` and in the stem's backward
region (from the mark ``dpc.backbone.stem.backward`` to the end of the
step's backward) in the traced window."""

from benchmark import counts, spans


def read(ctx):
    cell = ctx["cell"]
    flops, nbytes = counts.stem_cost(cell.config, cell.traffic["batch"])
    return spans.share_of_roofline(flops, nbytes, spans.device_ms(
        ctx, "dpc.backbone.stem", "dpc.backbone.stem.backward"))
