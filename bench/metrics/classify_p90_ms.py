"""The 90th percentile of the window's request latencies (call to
predictions on the host), in ms; the sample count is the result line's
``requests``."""
import statistics


def read(ctx):
    if len(ctx.latencies) < 2:
        return None
    return statistics.quantiles(ctx.latencies, n=10, method="inclusive")[8] * 1e3
