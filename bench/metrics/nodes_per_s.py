"""AIG nodes classified in the window over the window's seconds: every
completed request's nodes, over all the time from the first request's
start to the last one's end."""


def read(ctx):
    if not ctx.requests:
        return None
    return ctx.requests * ctx.num_nodes / ctx.window_s
