"""``Session.prepare``'s own timings summed (features and edge graph, then
partitioning and re-growth), in set-up."""


def read(ctx):
    return sum(ctx.prepare_timings.values())
