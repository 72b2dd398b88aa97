"""K1, the LD kernel: its least time for the profiled requests (the LD
rows' bytes and FLOPs of ``bench/counts.py``) over the device time of the
kernels named below, in %.  A kernel renamed or fused needs its name here."""
import re

KERNELS = re.compile(r"^ld_kernel<")


def read(ctx):
    p = ctx.profile
    if p is None or ctx.counts is None or not ctx.counts["ld"]["launches"]:
        return None
    t = sum(s for name, s in p["kernel_s"].items() if KERNELS.search(name))
    if t <= 0:
        return None
    return 100.0 * p["requests"] * ctx.counts["ld"]["t_min"] / t
