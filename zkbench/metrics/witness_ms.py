"""Mean host milliseconds of the circuit's witness call, a span the driver
times around it (RSA: RsaCircuit.witness), over the proofs wholly inside
the traced stretch (the proof that the profiler's start stalls lies before
it)."""


def read(run):
    xs = [p.witness_s for p in run.traced if p.witness_s is not None]
    return 1e3 * sum(xs) / len(xs) if xs else None
