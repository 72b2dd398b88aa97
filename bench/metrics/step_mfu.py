"""The forward's model FLOPs a request (``bench/counts.py``), times the
requests completed in the traced run's window, over its seconds times the
float32 peak, in %."""


def read(ctx):
    if not ctx.requests or ctx.counts is None:
        return None
    flops = ctx.requests * ctx.counts["model_flops"]
    return 100.0 * flops / (ctx.window_s * ctx.peaks.F32_FLOPS)
