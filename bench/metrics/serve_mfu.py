"""The model FLOPs of the window's batches (``bench/counts.py``
``lm_batch_flops``: every prefill and decode step, padded prompt positions
and attention over the cache counted) over the window's seconds times the
bf16 peak, in %."""


def read(ctx):
    if not ctx.tokens:
        return None
    return 100.0 * ctx.model_flops / (ctx.window_s * ctx.peaks.BF16_FLOPS)
