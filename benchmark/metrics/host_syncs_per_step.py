"""Blocking runtime calls a step (stream, device and event synchronizes
and synchronous copies) inside the loop's ``dpc.loop.dispatch``, its
nested spans included; the drain's one wait a step is outside it."""

from benchmark import spans


def read(ctx):
    s = spans.of(ctx)
    d = s["spans"].get("dpc.loop.dispatch") if s else None
    return d["syncs_within"] if d else None
