"""Proofs that returned inside the window, over the window's seconds."""


def read(run):
    return len(run.completed) / run.seconds
