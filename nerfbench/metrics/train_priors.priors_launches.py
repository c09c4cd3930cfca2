"""Device operations launched inside the step's ``priors`` span, per
profiled step; nothing where no step ran the priors."""

from nerfbench.tracing import under_span


def read(run):
    tr = getattr(run, "trace", None)
    if run.kind != "train" or tr is None:
        return None
    n, _ = under_span(tr["ops"], "priors")
    return n / tr["units"] if n else None
