"""The encode backward's share of its roofline in training: the logical
backward's least time (``counts.py``) over the device time of the
operations launched inside the ``encode_bwd`` span, per step, in
percent."""

from nerfbench.tracing import under_span


def read(run):
    tr, work = getattr(run, "trace", None), getattr(run, "work", None)
    if run.kind != "train" or tr is None or work is None:
        return None
    n, sec = under_span(tr["ops"], "encode_bwd")
    if not n or sec <= 0:
        return None
    return 100.0 * work["encode_bwd_least_s"] * tr["units"] / sec
