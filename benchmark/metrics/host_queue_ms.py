"""Host ms a step in which the epoch loop queues the step
(``dpc.loop.dispatch``), less the host time of the blocking runtime calls
inside it: the host's own work of queuing a step, in the traced
window."""

from benchmark import spans


def read(ctx):
    s = spans.of(ctx)
    d = s["spans"].get("dpc.loop.dispatch") if s else None
    return d["host_ms"] - d["sync_ms_within"] if d else None
