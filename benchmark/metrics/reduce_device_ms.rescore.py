"""Device milliseconds a rescore of the operations launched inside the
benchmark's span around ``DeviceRescorer.score`` (dedup, the float64
per-read sums and the reduction)."""


def read(run):
    tr = run.tracer.trace
    if tr is None or not tr.span_count("score"):
        return None
    spent = tr.op_seconds_in("score")
    return 1e3 * spent / tr.span_count("score") if spent > 0 else None
