"""Host-to-device bytes the streamed executor staged
(``exec_stats["bytes_h2d"]``) a request, over the traced run's window, in
MiB."""


def read(ctx):
    if not ctx.exec_stats:
        return None
    return sum(s.get("bytes_h2d", 0) for s in ctx.exec_stats) / len(ctx.exec_stats) / 2**20
