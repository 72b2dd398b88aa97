"""The streamed route's consumer blocked on the prefetch queue: the
``exec.wait`` spans over the ``exec.stream`` spans, each summed over the
traced run's window, in %."""


def read(ctx):
    waits = [s.duration for s in ctx.spans if s.name == "exec.wait"]
    streams = sum(s.duration for s in ctx.spans if s.name == "exec.stream")
    if not waits or streams <= 0:
        return None
    return 100.0 * sum(waits) / streams
