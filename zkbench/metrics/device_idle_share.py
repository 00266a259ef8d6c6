"""The card's idle share of the traced stretch, in %: 1 - the union of every
device operation of every stream of the process, over the stretch."""


def read(run):
    tr = run.trace
    return None if tr is None else 100.0 * (1.0 - tr.busy_s / tr.window_s)
