"""The streamed executor's host packing time (``exec_stats["pack_s"]``, on
its prefetch thread, hashing included) over its wall time
(``exec_stats["wall_s"]``), summed over the traced run's window, in %."""


def read(ctx):
    wall = sum(s.get("wall_s", 0.0) for s in ctx.exec_stats)
    if wall <= 0:
        return None
    return 100.0 * sum(s.get("pack_s", 0.0) for s in ctx.exec_stats) / wall
