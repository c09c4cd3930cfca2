"""A Mip-NeRF 360 step's model operations (``counts_mipnerf360.step_flops``:
the two MLPs' forward and backward at the samples each level evaluated a
step, from the program's counters over the profiled steps) over the
device's busy time a profiled step times the float32 peak, in percent."""

from nerfbench.counts import PEAK_F32_FLOPS


def read(run):
    tr, work = getattr(run, "trace", None), getattr(run, "work", None)
    if (run.kind != "train_mipnerf360" or tr is None or work is None
            or tr["busy_s"] <= 0):
        return None
    return 100.0 * work["flops_per_unit"] * tr["units"] / (tr["busy_s"]
                                                          * PEAK_F32_FLOPS)
