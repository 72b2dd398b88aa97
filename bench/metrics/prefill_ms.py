"""One batch's prefill (``BatchServer.prefill``: the cache built and the
last logits), synchronised on both sides, in the batch served after the
window, in ms."""


def read(ctx):
    return 1e3 * ctx.prefill_s
