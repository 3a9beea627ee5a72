"""Milliseconds a move in the program's span ``score.reduce``: the
floored reduction over every read (``get_total_prob_from_logs``)."""

from harness.program_trace import per_move_ms


def read(run):
    return per_move_ms(run, "score.reduce")
