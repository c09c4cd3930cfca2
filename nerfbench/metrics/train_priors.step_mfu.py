"""The training step's model operations (network forward and backward,
the encode's interpolation forward and backward, counted from the
configuration's shapes) over the wall time of a window step times the
float32 peak, in percent."""

from nerfbench.counts import PEAK_F32_FLOPS


def read(run):
    work = getattr(run, "work", None)
    if run.kind != "train" or work is None:
        return None
    return 100.0 * work["flops_per_unit"] / (run.window["unit_wall_s"]
                                             * PEAK_F32_FLOPS)
