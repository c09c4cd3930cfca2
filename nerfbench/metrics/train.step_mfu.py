"""The training step's model operations (network forward and backward,
the encode's interpolation forward and backward, counted from the
configuration's shapes) over the device's busy time a profiled step times
the float32 peak, in percent: the whole step's share of the peak on the
device's time, which bounds the encode's rooflines."""

from nerfbench.counts import PEAK_F32_FLOPS


def read(run):
    tr, work = getattr(run, "trace", None), getattr(run, "work", None)
    if run.kind != "train" or tr is None or work is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * work["flops_per_unit"] * tr["units"] / (tr["busy_s"]
                                                          * PEAK_F32_FLOPS)
