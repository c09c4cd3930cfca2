"""Share of the profiled training steps' wall time in which no operation
ran on the device (1 - busy_s / window_s of the traced stretch), in
percent. The profiler slows the host, so a host-bound step reads a higher
idle share traced than it has untraced."""


def read(run):
    tr = getattr(run, "trace", None)
    if run.kind != "train" or tr is None or tr["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
