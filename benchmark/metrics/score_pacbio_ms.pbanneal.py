"""Milliseconds of the long-read library's scoring inside each scoring
call (the program's span ``score.pacbio``: the fill of the call's missing
windows, every walk's sweep of its hits, the reduction) over the
window's moves.  None where the program has no such span."""

from harness.program_trace import per_move_ms, store


def read(run):
    st = store()
    if st is None or not st.span_stats("score.pacbio")[0]:
        return None
    return per_move_ms(run, "score.pacbio")
