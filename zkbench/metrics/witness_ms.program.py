"""Host milliseconds a proof in the program's `witness` spans: the RSA
witness tape (`RsaCircuit.witness`) and the calls of both phase callables
inside `create_proof`, over the proofs wholly inside the traced stretch."""
from zkbench.spans import traced


def read(run):
    got = traced(run)
    if got is None:
        return None
    secs = sum(sp.seconds for sp in got[0] if sp.name == "witness")
    return 1e3 * secs / len(run.traced)
