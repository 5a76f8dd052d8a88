"""Device ms a step of the recipe inside the real step: every kernel and
copy launched under the program's span ``dpc.step.recipe`` in the traced
window (the draws' copy, crop, flip, gray, jitter and normalize), a
step."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "dpc.step.recipe")
