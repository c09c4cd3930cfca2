"""Host milliseconds a window step spends taking its batch from the
trainer's sampler and queueing its copy to the device (the benchmark's own
``nerfbench.sampler`` span, timed on the host clock)."""


def read(run):
    if run.kind != "train" or getattr(run, "trace", None) is None:
        return None
    return 1e3 * run.window["sampler_s"]
