"""``peak_gib``: ``torch.cuda.max_memory_allocated()`` over the window,
its count reset after set-up, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
