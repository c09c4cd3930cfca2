"""Share of the profiled requests' wall time in which no operation ran on
the device (1 - busy_s / window_s of the traced stretch), in percent."""


def read(run):
    tr = getattr(run, "trace", None)
    if run.kind != "serve" or tr is None or tr["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
