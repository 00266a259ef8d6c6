"""X.509 chain aggregation: 4 inner snarks (2 links x {SHA256, RSA}) ->
one accumulator proof.

Counterpart of halo2_zkcert_tpu/circuits/x509_agg.py.

Parity target: `X509VerifierAggregationCircuit` (reference src/lib.rs:29-146).
Snark order matches the reference CLI (cli.rs:424-429): [rsa_1, sha_1,
rsa_2, sha_2].

Linking: the reference equality-links snark pair instances elementwise
(lib.rs:60-66) — which only type-checks when both circuits expose 32 digest
bytes, and leaves the byte<->u128 packing as a TODO (lib.rs:68).  Here the
RSA circuit exposes SHA256(TBS) as 32 big-endian bytes (circuits/rsa.py)
and the SHA256 circuit exposes [lo, hi] u128 halves (circuits/sha256.py,
helpers.rs:284-298 convention), so the link constrains the byte packing:
    hi == sum_{i<16} digest[i]  * 2^(8*(15-i))
    lo == sum_{i>=16} digest[i] * 2^(8*(31-i))
"""
from __future__ import annotations

from .aggregation import AggregationCircuit, InnerSnark


def _link_pair(gb, rsa_loader, sha_loader) -> None:
    rsa_bytes = [rsa_loader.instance_scalar(0, i) for i in range(32)]
    lo = sha_loader.instance_scalar(0, 0)
    hi = sha_loader.instance_scalar(0, 1)
    for target, chunk in ((hi, rsa_bytes[:16]), (lo, rsa_bytes[16:])):
        acc = chunk[0]
        for b in chunk[1:]:
            acc = gb.mul_add(acc, gb.constant(256), b)
        gb.assert_equal(acc, target)


def link_x509(gb, loaders) -> None:
    assert len(loaders) == 4, "expected [rsa_1, sha_1, rsa_2, sha_2]"
    _link_pair(gb, loaders[0], loaders[1])
    _link_pair(gb, loaders[2], loaders[3])


class X509VerifierAggregationCircuit(AggregationCircuit):
    """4-snark X.509 aggregation with digest linking (reference lib.rs:42
    asserts exactly 4 snarks)."""

    def __init__(self, snarks: list, k: int = 22, lanes: int = 4,
                 na: int = 2, nl: int = 1, universal: bool = False,
                 keep_identity_terms: bool = False):
        assert len(snarks) == 4, "X509 aggregation takes exactly 4 snarks"
        super().__init__(snarks, k, lanes=lanes, na=na, nl=nl,
                         link=link_x509, universal=universal,
                         keep_identity_terms=keep_identity_terms)
