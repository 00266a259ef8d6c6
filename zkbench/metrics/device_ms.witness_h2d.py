"""Device milliseconds a proof of the witness columns' hand-over to the card,
from the device intervals of the program's `witness_h2d` spans, over the
proofs wholly inside the traced stretch.  A program without the span reads
nothing."""
from zkbench.spans import traced


def read(run):
    got = traced(run)
    if got is None:
        return None
    ms = [sp.device_ms for sp in got[0]
          if sp.name == "witness_h2d" and sp.device_ms is not None]
    return sum(ms) / len(run.traced) if ms else None
