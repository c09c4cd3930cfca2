"""Device operations (kernels, copies, sets) per profiled training step."""


def read(run):
    tr = getattr(run, "trace", None)
    if run.kind != "train" or tr is None:
        return None
    return len(tr["ops"]) / tr["units"]
