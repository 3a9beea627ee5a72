"""Host milliseconds a long-read rescore (the program's counter
``pacbio.scores``) in the program's spans ``pacbio.windows`` (the missing
windows, their ranges and reservations), ``pacbio.apply`` (the hits into
the cache), ``pacbio.sweep`` (every walk's positions, coverage sweep and
per-read sums) and ``pacbio.reduce`` (the floored reduction)."""

from harness.pacbio_spans import per_pacbio_score_ms


def read(run):
    return per_pacbio_score_ms("pacbio.windows", "pacbio.apply",
                               "pacbio.sweep", "pacbio.reduce")
