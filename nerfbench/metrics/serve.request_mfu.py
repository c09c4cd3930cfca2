"""A request's model operations (network forward and the encode's
interpolation over every sample) over the window's median request time
times the float32 peak, in percent."""

from nerfbench.counts import PEAK_F32_FLOPS


def read(run):
    work = getattr(run, "work", None)
    if run.kind != "serve" or work is None:
        return None
    return 100.0 * work["flops_per_unit"] / (run.window["unit_wall_s"]
                                             * PEAK_F32_FLOPS)
