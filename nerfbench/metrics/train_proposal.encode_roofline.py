"""The three hash grids' encode forwards' share of their roofline in a
nerfacto step: their least time (``counts_nerfacto.py``, from the first
profiled step's points) over the device time of the operations launched
inside the program's ``encode`` spans, per step, in percent."""

from nerfbench.tracing import under_span


def read(run):
    tr, work = getattr(run, "trace", None), getattr(run, "work", None)
    if run.kind != "train_proposal" or tr is None or work is None:
        return None
    n, sec = under_span(tr["ops"], "encode")
    if not n or sec <= 0:
        return None
    return 100.0 * work["encode_least_s"] * tr["units"] / sec
