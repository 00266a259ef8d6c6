"""K4's share of its roofline, in %: the least time of one launch (the
tape's products a row x the extended domain's rows, at the peaks'
operations a product and rate; counts/<config>.json) over the mean device
time of a k_quotient_forest launch in the traced stretch."""


def read(run):
    tr, c = run.trace, run.counts
    if tr is None or "quotient_products_per_row" not in c:
        return None
    secs = sum(v for k, v in tr.device_s.items() if "k_quotient_forest" in k)
    seen = sum(v for k, v in tr.launches.items() if "k_quotient_forest" in k)
    if not seen:
        return None
    pk = c["peaks"]
    bound_s = (c["quotient_products_per_row"] * c["extended_rows"]
               * pk["ops_per_product"] / pk["ops_per_s"])
    return 100.0 * bound_s / (secs / seen)
