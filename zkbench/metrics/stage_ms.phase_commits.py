"""Mean milliseconds of the prover's "phase commits" stage (plonk/prover.py
LAST_STAGE_TIMES, device-synchronised at its end) over the proofs wholly
inside the traced stretch."""

STAGE = "phase commits"


def read(run):
    xs = [p.stages[STAGE] for p in run.traced if STAGE in p.stages]
    return 1e3 * sum(xs) / len(xs) if xs else None
