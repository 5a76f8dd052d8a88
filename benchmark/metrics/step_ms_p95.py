"""The 95th percentile of the window's step times on rank 0: the gaps
between CUDA events recorded after consecutive steps, read after the
window (no step waits for the card)."""

import numpy as np


def read(ctx):
    times = ctx["rank0"].get("step_ms")
    return float(np.percentile(times, 95)) if times else None
