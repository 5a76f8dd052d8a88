"""Clips a second: every clip the window's steps completed, on all ranks,
over the window's wall time, which ends in a synchronize after the last
step's Adam update."""


def read(ctx):
    r0 = ctx["rank0"]
    clips = r0["steps"] * ctx["cell"].traffic["batch"] * len(ctx["ranks"])
    return clips / r0["window_s"]
