"""The routed experts' grouped GEMMs of the traced batch: their least time
(``bench/counts_afmoe.py`` ``expert_gemms`` of each MoE call's pairs and
active experts, as its ``moe.experts`` span records them) over the device
time of the kernels launched by the op named below, in %.  A GEMM by
another op needs its name here."""
OP = "aten::_grouped_mm"


def read(ctx):
    by_op, t_min = getattr(ctx, "device_by_op", None), getattr(ctx, "expert_t_min", None)
    if not by_op or not t_min or by_op.get(OP, 0.0) <= 0:
        return None
    return 100.0 * t_min / by_op[OP]
