"""The fixed-base MSM's share of its roofline, in %: the least time of a
proof's counted MSM work over the device time a proof of device_ms.msm's
kernels (`k_scan_madd`, `k_point_scan`, `k_point_reduce`, `k_point_add`)
in the traced stretch.  The work, from the program's counters over the
proofs wholly inside the stretch: each scheduled pair one mixed addition
into its bucket (11 products), and each column's 2^wbits buckets a running
sum and a sum of sums (2 x (2^wbits - 1) x 12 products), at the peaks'
operations a product and rate."""
from zkbench.spans import traced

MSM_KERNELS = ("k_scan_madd", "k_point_scan", "k_point_reduce",
               "k_point_add")


def read(run):
    got = traced(run)
    if got is None:
        return None
    c = {k: sum(p.get(k, 0) for p in got[1])
         for k in ("pairs", "buckets", "columns")}
    secs = sum(v for k, v in run.trace.device_s.items()
               if any(m in k for m in MSM_KERNELS))
    if not c["pairs"] or not secs:
        return None
    products = 11 * c["pairs"] + 2 * 12 * (c["buckets"] - c["columns"])
    pk = run.counts["peaks"]
    bound_s = products * pk["ops_per_product"] / pk["ops_per_s"] / len(got[1])
    return 100.0 * bound_s / (secs / len(run.traced))
