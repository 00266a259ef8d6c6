"""Device-idle milliseconds a proof while the program's innermost open span
is `blinding` (the BlindingRng draws of `create_proof` with their copies to
the card), over the proofs wholly inside the traced stretch."""
from zkbench.spans import idle_pieces, traced


def read(run):
    got = traced(run)
    if got is None:
        return None
    secs = sum(t for t, sp in idle_pieces(run, got[0])
               if sp is not None and sp.name == "blinding")
    return 1e3 * secs / len(run.traced)
