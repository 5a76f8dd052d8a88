"""Device ms a step in which a copy the feed launched (under
``dpc.feed.copy``) ran and no other device operation did: the part of
the host-to-device copy the compute stream does not hide, in the traced
window."""

from benchmark import spans


def read(ctx):
    s = spans.of(ctx)
    return s["feed_exposed_ms"] if s else None
