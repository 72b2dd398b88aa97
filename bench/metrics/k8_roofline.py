"""K8's prefill launches in the traced batch (one a layer: windowed on the
sliding layers, causal on the full ones): their least time
(``bench/counts_afmoe.py`` ``k8_prefill``: the (query, key) pairs the masks
keep, whatever computes them) over the device time of the kernels named
below, in %.  A kernel renamed or fused needs its name here."""
import re

KERNELS = re.compile(r"(^|::)flash_(wgmma_)?kernel\b")


def read(ctx):
    p, k8 = ctx.profile, getattr(ctx, "k8", None)
    if p is None or not k8:
        return None
    t = sum(s for name, s in p["kernel_s"].items() if KERNELS.search(name))
    if t <= 0:
        return None
    return 100.0 * k8["t_min"] / t
