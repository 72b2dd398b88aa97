"""Mean duration of the front door's ``plan`` span a request (routing, and
for a partitioned design the plan of its launches), in ms, over the traced
run's window."""


def read(ctx):
    plans = [s.duration for s in ctx.spans if s.name == "plan"]
    if not plans:
        return None
    return 1e3 * sum(plans) / len(plans)
