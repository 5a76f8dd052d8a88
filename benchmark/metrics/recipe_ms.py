"""CUDA-event milliseconds of the step's device recipe on one batch of the
cell (the draws, their copy and the crop, flip, gray, jitter and
normalize)."""


def read(ctx):
    return ctx["rank0"].get("pieces", {}).get("recipe")
