"""Self milliseconds of a move's proposal over the window's moves: the
program's span ``propose`` (``Optimizer.step``'s proposal loop) less the
spans opened inside it, which are the scoring its moves call."""

from harness.program_trace import per_move_ms


def read(run):
    return per_move_ms(run, "propose", self_time=True)
