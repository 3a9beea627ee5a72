"""Host milliseconds a long-read rescore (the program's counter
``pacbio.scores``) in the program's spans ``pacbio.chain``: spelling the
ranges, their k-mer indexes, the seed hits, chaining and guides."""

from harness.pacbio_spans import per_pacbio_score_ms


def read(run):
    return per_pacbio_score_ms("pacbio.chain")
