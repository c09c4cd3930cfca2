"""The three hash grids' encode backwards' share of their roofline in a
nerfacto step: their least time (``counts_nerfacto.py``: the field's every
step, the proposals' on the traced steps' share of updates) over the
device time of the operations launched inside the program's
``encode_bwd`` spans, per step, in percent."""

from nerfbench.tracing import under_span


def read(run):
    tr, work = getattr(run, "trace", None), getattr(run, "work", None)
    if run.kind != "train_proposal" or tr is None or work is None:
        return None
    n, sec = under_span(tr["ops"], "encode_bwd")
    if not n or sec <= 0:
        return None
    return 100.0 * work["encode_bwd_least_s"] * tr["units"] / sec
