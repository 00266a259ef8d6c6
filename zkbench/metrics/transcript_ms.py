"""Host milliseconds a proof inside the program's Poseidon transcript calls
(its proof counter `transcript_s`: common_scalar, write_point,
write_scalar, squeeze_challenge, finalize), over the proofs wholly inside
the traced stretch."""
from zkbench.spans import traced


def read(run):
    got = traced(run)
    if got is None:
        return None
    secs = sum(c.get("transcript_s", 0.0) for c in got[1])
    return 1e3 * secs / len(run.traced) if secs else None
