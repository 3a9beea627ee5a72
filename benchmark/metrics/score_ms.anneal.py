"""Mean milliseconds of a move's scoring (``calc_prob``) over the window's
moves: the program's own ``Optimizer.metrics`` timer ``rescore``."""


def read(run):
    moves = run.layer.get("moves")
    return 1e3 * run.layer["rescore_s"] / moves if moves else None
