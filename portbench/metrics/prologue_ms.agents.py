"""Host milliseconds of the traced simulation's prologue, before its first
step: the seed draw on the host, the state's upload and the key
(``agents.prologue``, `harness.ranges`), while the card waits. None
unless the capture holds one prologue and a range for every step."""

from harness import ranges


def read(run):
    if ranges.steps(run) is None:
        return None
    prologue = ranges.spans(run.capture, "agents.prologue")
    if len(prologue) != 1:
        return None
    start, end = prologue[0]
    return (end - start) / 1e6
