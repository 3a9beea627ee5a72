"""Windows the aligners sent to the card (the program's counter
``align.device_windows``, summed over every batch of the window) over
the window's moves.  None where the program has no such counter."""

from harness.program_trace import store


def read(run):
    st, moves = store(), run.layer.get("moves")
    if st is None or not moves or "align.device_windows" not in \
            st.counters:
        return None
    return st.counters["align.device_windows"] / moves
