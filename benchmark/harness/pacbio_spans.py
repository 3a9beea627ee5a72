"""The long-read scorer's spans for the metric readers: host milliseconds
a rescore in some of the program's ``pacbio.*`` spans, from the program's
trace store (``harness/program_trace.py``).  None where there is nothing
to read: an untraced run, or a program without those spans and the
counter ``pacbio.scores``."""
from __future__ import annotations

from harness.program_trace import store


def per_pacbio_score_ms(*spans: str):
    """Milliseconds of the spans ``spans`` (their totals) over the
    program's counter ``pacbio.scores`` (one a ``calc_score_for_pacbio``)."""
    st = store()
    scores = st.counters.get("pacbio.scores", 0) if st is not None else 0
    if not scores:
        return None
    total = sum(st.span_stats(name)[1] for name in spans)
    return 1e3 * total / scores
