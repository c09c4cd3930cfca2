"""Device operations (kernels, copies, sets) per profiled request."""


def read(run):
    tr = getattr(run, "trace", None)
    if run.kind != "serve" or tr is None:
        return None
    return len(tr["ops"]) / tr["units"]
