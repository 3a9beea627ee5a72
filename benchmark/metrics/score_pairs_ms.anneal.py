"""Milliseconds a move in the program's span ``score.pairs``: the erased
and added walks' pair contributions (``calc_score_for_path_inc``) and
their accumulation into the running per-read totals and their logs."""

from harness.program_trace import per_move_ms


def read(run):
    return per_move_ms(run, "score.pairs")
