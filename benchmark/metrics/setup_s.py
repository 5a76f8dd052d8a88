"""Seconds from the process's start to the first timed step: imports,
kernel builds on a checkout's first run, weights, the ring, the first
steps and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
