"""The 95th percentile of every proof's latency: each proof started in the
window, the one that returns after its close included (its wait counts)."""
from zkbench.stats import quantile


def read(run):
    lat = [p.end - p.start for p in run.finished]
    return quantile(lat, 0.95) if lat else None
