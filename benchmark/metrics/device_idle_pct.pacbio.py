"""100 minus the share of the traced window that the union of device
operations (kernels, copies, fills) covers."""


def read(run):
    tr = run.tracer.trace
    return tr.idle_pct() if tr is not None else None
