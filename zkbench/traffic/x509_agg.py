"""One certificate chain of two links from the seed: an RSA-2048 issuer
signing a leaf TBS and an RSA-4096 root signing the intermediate's TBS, each
TBS of uniformly drawn length in the cell's `tbs_bytes` range and random
bytes, signed under PKCS#1 v1.5 with SHA-256.  Every job proves the same
chain's aggregation again with fresh blinding."""
from __future__ import annotations

import random

from .rsa import keypair, sign


def make(config: dict, cell: dict, rng: random.Random) -> dict:
    lo, hi = cell["tbs_bytes"]
    links = []
    for bits in config["link_bits"]:
        key = keypair(bits, config["public_exponent"], rng)
        tbs = rng.randbytes(rng.randint(lo, hi))
        links.append({"modulus": key["n"], "tbs": tbs,
                      "signature": sign(key, tbs)})
    return {"links": links, "jobs": cell["jobs"]}
