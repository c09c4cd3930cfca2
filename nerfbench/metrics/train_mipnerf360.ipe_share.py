"""Share of a profiled Mip-NeRF 360 step's busy device time in the
operations launched inside the program's ``ipe`` span (the frustums'
Gaussians, their contraction and the integrated encoding, at all three
levels), in percent; nothing where no operation ran under that span."""

from nerfbench.tracing import under_span


def read(run):
    tr = getattr(run, "trace", None)
    if run.kind != "train_mipnerf360" or tr is None or tr["busy_s"] <= 0:
        return None
    n, sec = under_span(tr["ops"], "ipe")
    if not n:
        return None
    return 100.0 * sec / tr["busy_s"]
