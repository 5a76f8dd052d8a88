"""The most device memory the allocator held at once over set-up and the
window (``torch.cuda.max_memory_allocated``), the largest of the ranks."""


def read(ctx):
    return max(r["peak_bytes"] for r in ctx["ranks"]) / 2 ** 30
