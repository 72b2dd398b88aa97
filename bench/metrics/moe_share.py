"""The device seconds of the kernels launched inside the program's ``moe.*``
spans (``zoo/models/moe.py``: routing, dispatch, the experts, the shared
expert, the combine; each kernel put down to the span its launching op began
in) over the traced batch's busy seconds, in %."""


def read(ctx):
    p, s = ctx.profile, getattr(ctx, "moe_device_s", None)
    if p is None or not s or p["busy_s"] <= 0:
        return None
    return 100.0 * s / p["busy_s"]
