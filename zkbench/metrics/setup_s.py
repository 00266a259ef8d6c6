"""Seconds from the process's start to the window's opening: imports, the
kernels' build or load, the SRS and its tables, the circuit and its key,
the warm-up proof; the benchmark's own making of the inputs from
the seed is left out."""


def read(run):
    return run.setup_s
