"""The host's structure hashing a request, in ms: the ``plan.key`` spans
(``kernels/plan_cache.py`` ``graph_key``, on every thread: the full route's
lookup, the streamed route's prefetch thread) summed over the traced run's
window, over its requests."""


def read(ctx):
    keys = [s.duration for s in ctx.spans if s.name == "plan.key"]
    if not keys or not ctx.requests:
        return None
    return 1e3 * sum(keys) / ctx.requests
