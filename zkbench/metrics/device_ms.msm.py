"""Device milliseconds a proof of the MSM's own kernels in the traced
stretch (K6 `k_scan_madd`, `k_point_scan*`, `k_point_reduce*`,
`k_point_add`), over the proofs wholly inside it.  Left out: the torch
gathers of table points that feed them (`vectorized_gather_kernel`) and
cub's radix sort, whose names the lookup argument's sort and other gathers
share; the breakdown lists them."""

MSM_KERNELS = ("k_scan_madd", "k_point_scan", "k_point_reduce",
               "k_point_add")


def read(run):
    tr, n = run.trace, len(run.traced)
    if tr is None or not n:
        return None
    secs = sum(v for k, v in tr.device_s.items()
               if any(m in k for m in MSM_KERNELS))
    return 1e3 * secs / n if secs else None
