"""The host's copies to the device a request, in ms: the ``gnn.stage``
spans (``core/gnn.py`` ``predict``'s edges and features, the packed
launch's new structure and its x, inv and slot) summed over the traced
run's window, over its requests."""


def read(ctx):
    stages = [s.duration for s in ctx.spans if s.name == "gnn.stage"]
    if not stages or not ctx.requests:
        return None
    return 1e3 * sum(stages) / ctx.requests
