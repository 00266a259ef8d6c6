"""The transforms' share of their roofline, in %: the least time of a
proof's transforms (counts/<config>.json `transforms`: k / 2 products an
element at the peaks' operations a product and rate) over their device time
a proof, k_ntt_pass's device time in the traced stretch over the proofs
wholly inside it."""


def read(run):
    tr, c, n = run.trace, run.counts, len(run.traced)
    if tr is None or "transforms" not in c or not n:
        return None
    secs = sum(v for k, v in tr.device_s.items() if "k_ntt_pass" in k)
    if not secs:
        return None
    pk = c["peaks"]
    products = sum(cols * (1 << k) * k / 2 for cols, k in c["transforms"])
    bound_s = products * pk["ops_per_product"] / pk["ops_per_s"]
    return 100.0 * bound_s / (secs / n)
