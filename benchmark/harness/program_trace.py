"""The program's own spans and counters, for the metric readers: the trace
store of gaml_tpu_torch (``utils.metrics.TRACE``), which the program fills
only while a torch.profiler profile records, so in a traced run it holds
the window and nothing else.  Each function returns None where there is
nothing to read: an untraced run, or a program without the store."""
from __future__ import annotations


def store():
    """The program's trace store, or None where it is absent or empty."""
    try:
        from gaml_tpu_torch.utils.metrics import TRACE
    except ImportError:
        return None
    return TRACE if TRACE.spans or TRACE.counters else None


def per_move_ms(run, span: str, self_time: bool = False):
    """Milliseconds of the spans ``span`` (their total, or their self
    time) over the window's moves."""
    st, moves = store(), run.layer.get("moves")
    if st is None or not moves:
        return None
    _calls, total, own = st.span_stats(span)
    return 1e3 * (own if self_time else total) / moves


def per_rescore_ms(sync: bool):
    """Host milliseconds a rescore (the program's counter
    ``rescore.calls``) in the ``sync`` spans under its ``rescore`` span,
    or, with ``sync`` false, in the rest of that span."""
    st = store()
    calls = st.counters.get("rescore.calls", 0) if st is not None else 0
    if not calls:
        return None
    _n, total, _own = st.span_stats("rescore")
    _n, waited, _own = st.span_stats("sync", under="rescore")
    return 1e3 * (waited if sync else total - waited) / calls
