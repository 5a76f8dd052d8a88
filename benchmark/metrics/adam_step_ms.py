"""Device ms a step of the Adam update: every kernel launched under the
program's span ``dpc.step.optimizer`` in the traced window."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "dpc.step.optimizer")
