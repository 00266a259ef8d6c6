"""Host milliseconds a proof in the program's `replay` spans: a composed
circuit's phase-1 columns replayed at the proof's challenge from the build
pass's record, over the proofs wholly inside the traced stretch.  A program
without the span reads nothing."""
from zkbench.spans import traced


def read(run):
    got = traced(run)
    if got is None:
        return None
    secs = [sp.seconds for sp in got[0] if sp.name == "replay"]
    return 1e3 * sum(secs) / len(run.traced) if secs else None
