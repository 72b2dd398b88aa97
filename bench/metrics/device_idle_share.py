"""The share of the profiled requests' wall time in which no kernel or copy
ran on the device, in %."""


def read(ctx):
    p = ctx.profile
    if p is None or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
