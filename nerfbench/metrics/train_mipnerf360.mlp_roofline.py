"""The two MLPs' forward GEMMs against their FMA roofline in a Mip-NeRF 360
step: their forward operations a step (``counts_mipnerf360.forward_flops``,
from the program's counters) over the device time of the operations
launched inside the program's ``mlp`` spans a step times the float32 peak,
in percent (the backward runs on autograd's thread, outside the span)."""

from nerfbench.counts import PEAK_F32_FLOPS
from nerfbench.tracing import under_span


def read(run):
    tr, work = getattr(run, "trace", None), getattr(run, "work", None)
    if run.kind != "train_mipnerf360" or tr is None or work is None:
        return None
    n, sec = under_span(tr["ops"], "mlp")
    if not n or sec <= 0:
        return None
    return 100.0 * work["mlp_forward_flops_per_unit"] * tr["units"] / (
        sec * PEAK_F32_FLOPS)
