"""K5's share of its bound: the least time the traced requests' forward
jobs could take (harness.bounds.forward_bound on each request's jobs as
the reference makes them: their read lengths, the band width, the walk
buffer's bases) over the device time of ``banded_forward_kernel``."""


def read(run):
    tr = run.tracer.trace
    if tr is None:
        return None
    spent = tr.op_seconds(lambda n: "banded_forward_kernel" in n)
    calls = run.layer.get("traced_calls", [])
    if spent <= 0 or not calls:
        return None
    bound = sum(run.work[k]["forward"]["bound_ms"] for k in calls) / 1e3
    return 100.0 * bound / spent
