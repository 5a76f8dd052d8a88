"""The share of the traced window in which no operation ran on the card
(the union of kernels, copies and sets on every stream), the ranks'
mean."""

import statistics


def read(ctx):
    traces = [r.get("trace") for r in ctx["ranks"]]
    if not all(traces):
        return None
    busy = statistics.fmean(t["busy_s"] for t in traces)
    window = statistics.fmean(t["window_s"] for t in traces)
    return 100.0 * (1.0 - busy / window)
