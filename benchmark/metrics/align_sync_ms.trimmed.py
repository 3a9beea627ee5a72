"""Milliseconds a move in the program's ``sync`` spans under its span
``align.device``: the host blocked on the card (candgen's count, the
extension's fetch), over the window's moves.  None where the program
opened no ``align.device`` span."""

from harness.program_trace import store


def read(run):
    st, moves = store(), run.layer.get("moves")
    if st is None or not moves or not st.span_stats("align.device")[0]:
        return None
    _n, waited, _own = st.span_stats("sync", under="align.device")
    return 1e3 * waited / moves
