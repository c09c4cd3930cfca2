"""Share of a profiled nerfacto step's busy device time in the operations
launched inside the program's ``proposal`` span (the proposal chain: its
fields' encodes and networks, their weights and the PDF draws), in
percent; nothing where no operation ran under that span."""

from nerfbench.tracing import under_span


def read(run):
    tr = getattr(run, "trace", None)
    if run.kind != "train_proposal" or tr is None or tr["busy_s"] <= 0:
        return None
    n, sec = under_span(tr["ops"], "proposal")
    if not n:
        return None
    return 100.0 * sec / tr["busy_s"]
