"""Device operations (kernels, copies, sets) per profiled Mip-NeRF 360
step."""


def read(run):
    tr = getattr(run, "trace", None)
    if run.kind != "train_mipnerf360" or tr is None:
        return None
    return len(tr["ops"]) / tr["units"]
