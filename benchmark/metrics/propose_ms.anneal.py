"""Mean milliseconds of a move's proposal over the window's moves: the
program's own ``Optimizer.metrics`` timer ``propose``."""


def read(run):
    moves = run.layer.get("moves")
    return 1e3 * run.layer["propose_s"] / moves if moves else None
