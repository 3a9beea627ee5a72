"""The candgen kernels' share of their bound: the least time the traced
rescores' candidate generation could take (harness.bounds.candgen_bound
on each rescore's window codes, candidates, runs and index) over the
device time of the kernels named ``candgen_*``."""


def read(run):
    tr = run.tracer.trace
    if tr is None:
        return None
    spent = tr.op_seconds(lambda n: "candgen_" in n)
    calls = run.layer.get("traced_calls", [])
    if spent <= 0 or not calls:
        return None
    bound = sum(run.work[c]["candgen"]["bound_ms"] for c in calls) / 1e3
    return 100.0 * bound / spent
