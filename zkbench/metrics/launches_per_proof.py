"""The program's kernel launches (ops/kernels.launches) from the window's
opening until every proof started in it returned, over those proofs."""


def read(run):
    if not run.proofs:
        return None
    return sum(run.launches.values()) / len(run.proofs)
