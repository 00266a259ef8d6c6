"""K4's share of its roofline, in %: the least time of a proof's K4 work
(the tape's products a row x the extended domain's rows, counted once a
proof, at the peaks' operations a product and rate; counts/<config>.json)
over K4's device time a proof, k_quotient_forest's device time in the
traced stretch over the proofs wholly inside it.  Both are a proof's,
whether the proof runs the tape in one launch over the extended domain or in
one launch a coset."""


def read(run):
    tr, c, n = run.trace, run.counts, len(run.traced)
    if tr is None or "quotient_products_per_row" not in c or not n:
        return None
    secs = sum(v for k, v in tr.device_s.items() if "k_quotient_forest" in k)
    if not secs:
        return None
    pk = c["peaks"]
    bound_s = (c["quotient_products_per_row"] * c["extended_rows"]
               * pk["ops_per_product"] / pk["ops_per_s"])
    return 100.0 * bound_s / (secs / n)
