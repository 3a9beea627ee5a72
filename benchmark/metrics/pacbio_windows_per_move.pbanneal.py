"""Long-read cache windows found missing (the program's counter
``pacbio.windows_missing``, summed over every fill of the window:
the scoring calls' and the moves' prefetches) over the window's moves.
None where the program has no such counter."""

from harness.program_trace import store


def read(run):
    st, moves = store(), run.layer.get("moves")
    if st is None or not moves or "pacbio.windows_missing" not in \
            st.counters:
        return None
    return st.counters["pacbio.windows_missing"] / moves
