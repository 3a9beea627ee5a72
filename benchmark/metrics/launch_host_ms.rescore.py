"""Host milliseconds a rescore in the program's span ``rescore`` outside
its ``sync`` spans: the launch work, during which the card waits."""

from harness.program_trace import per_rescore_ms


def read(run):
    return per_rescore_ms(sync=False)
