"""Window batches the aligners sent to the device in the window (their
``device_batches`` counters, which the start scoring's batches open) over
the window's moves; every other miss batch went to the native aligner."""


def read(run):
    moves = run.layer.get("moves")
    return run.layer["device_batches"] / moves if moves else None
