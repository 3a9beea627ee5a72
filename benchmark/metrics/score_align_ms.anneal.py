"""Milliseconds a move in the program's span ``score.align`` over every
``calc_prob`` of the move: the alignment-cache pass (the prefetch and
the paired scorer's lookups) and the misses' alignment, native or on
the device."""

from harness.program_trace import per_move_ms


def read(run):
    return per_move_ms(run, "score.align")
