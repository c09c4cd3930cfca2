"""The training rate on the host's clock: N_rand x the steps of an
untraced window over its seconds (a ``--trace 1`` run's window). Where the
step is host-bound it follows the host's speed, which wanders from run to
run by more than any bound could hold."""


def read(run):
    if run.kind != "train" or getattr(run, "trace", None) is None:
        return None
    return run.e2e.get("train_rays_per_s")
