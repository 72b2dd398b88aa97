"""K2, the HD kernel (its staged chunk pass and its combine): its least time
for the profiled requests (the HD rows' bytes and FLOPs of
``bench/counts.py``) over the device time of the kernels named below, in %.
A kernel renamed or fused needs its name here."""
import re

KERNELS = re.compile(r"^(hd_staged_kernel<|hd_combine_kernel)")


def read(ctx):
    p = ctx.profile
    if p is None or ctx.counts is None or not ctx.counts["hd"]["launches"]:
        return None
    t = sum(s for name, s in p["kernel_s"].items() if KERNELS.search(name))
    if t <= 0:
        return None
    return 100.0 * p["requests"] * ctx.counts["hd"]["t_min"] / t
