"""Milliseconds a move in the program's span ``align.device``: the device
route of the miss batches (candgen, the exact extension, the fetch and
the host's dedup into window columns), its deferred finish too, over the
window's moves.  None where the program opened no such span."""

from harness.program_trace import per_move_ms, store


def read(run):
    st = store()
    if st is None or not st.span_stats("align.device")[0]:
        return None
    return per_move_ms(run, "align.device")
