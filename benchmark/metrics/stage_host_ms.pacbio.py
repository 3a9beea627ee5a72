"""Host milliseconds a long-read rescore (the program's counter
``pacbio.scores``) in the program's spans ``pacbio.stage``: the batch's
concatenated targets, the job arrays, the guide steps and the uploads."""

from harness.pacbio_spans import per_pacbio_score_ms


def read(run):
    return per_pacbio_score_ms("pacbio.stage")
