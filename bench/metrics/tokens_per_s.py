"""Tokens generated by the window's completed requests over the window's
seconds: all the time from the first batch's start to the last one's end."""


def read(ctx):
    if not ctx.tokens:
        return None
    return ctx.tokens / ctx.window_s
