"""``torch.cuda.max_memory_allocated()`` over the window, reset after the
warm-up, in GiB."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / float(1 << 30)
