"""Device milliseconds a proof of the fixed-base MSM's gathers of table
points (`table_flat[rows_sorted]`), from the device intervals of the
program's `msm_gather` spans, over the proofs wholly inside the traced
stretch: the `vectorized_gather_kernel`s that are the MSM's, told apart
from the lookup's and every other gather."""
from zkbench.spans import traced


def read(run):
    got = traced(run)
    if got is None:
        return None
    ms = [sp.device_ms for sp in got[0]
          if sp.name == "msm_gather" and sp.device_ms is not None]
    return sum(ms) / len(run.traced) if ms else None
