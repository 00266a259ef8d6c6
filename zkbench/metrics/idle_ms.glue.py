"""Device-idle milliseconds a proof inside the program's `prove` span and
outside every `witness` and `blinding` span: the Python that issues the
launches (the MSM's included), the transcript and the host arithmetic
between them, over the proofs wholly inside the traced stretch."""
from zkbench.spans import idle_pieces, names, traced


def read(run):
    got = traced(run)
    if got is None:
        return None
    secs = 0.0
    for t, sp in idle_pieces(run, got[0]):
        held = names(sp)
        if "prove" in held and not held & {"witness", "blinding"}:
            secs += t
    return 1e3 * secs / len(run.traced)
