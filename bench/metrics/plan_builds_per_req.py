"""Plan-cache builds (``PLAN_CACHE.snapshot().builds``) over the traced
run's window, a request."""


def read(ctx):
    if not ctx.requests:
        return None
    return ctx.plan_builds / ctx.requests
