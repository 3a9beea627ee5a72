"""Host milliseconds a rescore in the program's ``sync`` spans under its
span ``rescore``: the host blocked on the card (the candidate count, the
dedup mask's count, the score's read-back)."""

from harness.program_trace import per_rescore_ms


def read(run):
    return per_rescore_ms(sync=True)
