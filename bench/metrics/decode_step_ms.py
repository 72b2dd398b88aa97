"""One decode step of the batch served after the window: from the end of
its prefill to its tokens on the host, over its decode steps, in ms."""


def read(ctx):
    return 1e3 * ctx.decode_step_s
