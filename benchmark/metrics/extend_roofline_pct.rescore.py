"""The exact extension's share of its bound: the least time the traced
rescores' extensions could take (harness.bounds.exact_bound on each
rescore's candidates) over the device time of ``gaml_extend_exact``'s
kernels (the candidates' ordering and the extension)."""

from harness.trace import short

KERNELS = ("extend_kernel", "order_count", "order_scan", "order_scatter")


def read(run):
    tr = run.tracer.trace
    if tr is None:
        return None
    spent = tr.op_seconds(lambda n: short(n).split("::")[-1] in KERNELS)
    calls = run.layer.get("traced_calls", [])
    if spent <= 0 or not calls:
        return None
    bound = sum(run.work[c]["extend"]["bound_ms"] for c in calls) / 1e3
    return 100.0 * bound / spent
