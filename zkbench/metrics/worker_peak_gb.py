"""torch.cuda.max_memory_allocated() of the prover process over set-up and
window, in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9
