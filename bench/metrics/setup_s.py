"""Process start to the first timed request: CUDA start, the design (the
checkout's cache), the weights, ``Session.prepare``, plan builds, warm-up."""


def read(ctx):
    return ctx.setup_s
