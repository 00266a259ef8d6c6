"""Device-idle milliseconds a proof while the program's innermost open span
is `replay` (the phase-1 replay), over the proofs wholly inside the traced
stretch.  A program without the span reads nothing."""
from zkbench.spans import idle_pieces, traced


def read(run):
    got = traced(run)
    if got is None or not any(sp.name == "replay" for sp in got[0]):
        return None
    secs = sum(t for t, sp in idle_pieces(run, got[0])
               if sp is not None and sp.name == "replay")
    return 1e3 * secs / len(run.traced)
