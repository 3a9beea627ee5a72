"""Miss batches the latency hybrid sent to the native aligner (the
program's counter ``align.native_batches``) over the window's moves: the
counterpart of ``device_batches_per_move``."""

from harness.program_trace import store


def read(run):
    st, moves = store(), run.layer.get("moves")
    if st is None or not moves:
        return None
    return st.counters.get("align.native_batches", 0) / moves
