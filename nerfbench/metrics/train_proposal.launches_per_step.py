"""Device operations (kernels, copies, sets) per profiled nerfacto step."""


def read(run):
    tr = getattr(run, "trace", None)
    if run.kind != "train_proposal" or tr is None:
        return None
    return len(tr["ops"]) / tr["units"]
