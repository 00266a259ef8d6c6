"""Minimal DER / X.509 parsing for RSA certificate chains.

Reference behavior (cited per function): the upstream zkCert src/helpers.rs.
Only the fields the zkcert pipeline needs are parsed: the raw TBS bytes,
the signature value, and the issuer's RSA public key modulus.  Parsing is
strict about structure but ignores extension semantics — chain *policy*
validation (expiry, key usage) is out of scope, exactly as in the reference
(README.md:5: the root is trusted, not verified).
"""
from __future__ import annotations

import base64
import hashlib
import os
import re
import socket
import ssl
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# DER primitives
# ---------------------------------------------------------------------------


class DerError(ValueError):
    pass


def _read_tlv(buf: bytes, off: int):
    """Parse one TLV at `off`: returns (tag, header_len, content_len)."""
    if off + 2 > len(buf):
        raise DerError("truncated TLV header")
    tag = buf[off]
    l0 = buf[off + 1]
    if l0 < 0x80:
        return tag, 2, l0
    nlen = l0 & 0x7F
    if nlen == 0 or off + 2 + nlen > len(buf):
        raise DerError("bad long-form length")
    clen = int.from_bytes(buf[off + 2:off + 2 + nlen], "big")
    return tag, 2 + nlen, clen


def _children(buf: bytes, off: int, end: int):
    """Iterate (tag, content_start, content_end, tlv_start) inside [off, end)."""
    while off < end:
        tag, hlen, clen = _read_tlv(buf, off)
        cstart = off + hlen
        cend = cstart + clen
        if cend > end:
            raise DerError("child overruns parent")
        yield tag, cstart, cend, off
        off = cend


SEQUENCE = 0x30
INTEGER = 0x02
BIT_STRING = 0x03
CONTEXT_0 = 0xA0


@dataclass
class Certificate:
    raw: bytes             # full DER certificate
    tbs: bytes             # raw DER of tbsCertificate (incl. header)
    signature: int         # signature value as big int
    modulus: int           # subject RSA public key modulus
    exponent: int          # subject RSA public key exponent

    @property
    def tbs_sha256(self) -> bytes:
        return hashlib.sha256(self.tbs).digest()


def parse_der(raw: bytes) -> Certificate:
    """Parse Certificate ::= SEQUENCE { tbsCertificate, sigAlg, sigValue }.

    Reference behavior: helpers.rs:75-95 (`extract_tbs_and_sig`) and
    helpers.rs:57-73 (`extract_public_key`, panics on non-RSA — here raises).
    """
    tag, hlen, clen = _read_tlv(raw, 0)
    if tag != SEQUENCE:
        raise DerError("certificate is not a SEQUENCE")
    top = list(_children(raw, hlen, hlen + clen))
    if len(top) != 3:
        raise DerError("certificate must have 3 elements")
    (t_tbs, tbs_s, tbs_e, tbs_tlv), _alg, (t_sig, sig_s, sig_e, _) = top
    if t_tbs != SEQUENCE or t_sig != BIT_STRING:
        raise DerError("unexpected tags in certificate")
    tbs = raw[tbs_tlv:tbs_e]
    sig_bits = raw[sig_s:sig_e]
    if not sig_bits or sig_bits[0] != 0:
        raise DerError("signature BIT STRING with unused bits unsupported")
    signature = int.from_bytes(sig_bits[1:], "big")

    # walk tbsCertificate for subjectPublicKeyInfo
    fields = list(_children(raw, tbs_s, tbs_e))
    idx = 0
    if fields and fields[0][0] == CONTEXT_0:   # [0] EXPLICIT version
        idx = 1
    # serialNumber, signature, issuer, validity, subject, subjectPublicKeyInfo
    spki = fields[idx + 5]
    if spki[0] != SEQUENCE:
        raise DerError("subjectPublicKeyInfo is not a SEQUENCE")
    spki_children = list(_children(raw, spki[1], spki[2]))
    if len(spki_children) != 2 or spki_children[1][0] != BIT_STRING:
        raise DerError("bad subjectPublicKeyInfo")
    alg = raw[spki_children[0][1]:spki_children[0][2]]
    # rsaEncryption OID 1.2.840.113549.1.1.1
    if b"\x2a\x86\x48\x86\xf7\x0d\x01\x01\x01" not in alg:
        raise DerError("issuer public key is not RSA (reference panics too, "
                       "helpers.rs:71)")
    kb_s, kb_e = spki_children[1][1], spki_children[1][2]
    keybits = raw[kb_s:kb_e]
    if not keybits or keybits[0] != 0:
        raise DerError("public key BIT STRING with unused bits unsupported")
    key = keybits[1:]
    ktag, khl, kcl = _read_tlv(key, 0)
    if ktag != SEQUENCE:
        raise DerError("RSAPublicKey is not a SEQUENCE")
    ints = list(_children(key, khl, khl + kcl))
    if len(ints) != 2 or any(t != INTEGER for t, *_ in ints):
        raise DerError("RSAPublicKey must be two INTEGERs")
    modulus = int.from_bytes(key[ints[0][1]:ints[0][2]], "big")
    exponent = int.from_bytes(key[ints[1][1]:ints[1][2]], "big")
    return Certificate(raw=raw, tbs=tbs, signature=signature,
                       modulus=modulus, exponent=exponent)


_PEM_RE = re.compile(
    b"-----BEGIN CERTIFICATE-----(.*?)-----END CERTIFICATE-----", re.S)


def parse_pem(pem: bytes) -> Certificate:
    m = _PEM_RE.search(pem)
    if not m:
        raise DerError("no PEM certificate found")
    der = base64.b64decode(b"".join(m.group(1).split()))
    return parse_der(der)


def extract_tbs_and_sig(cert: Certificate):
    """(tbs bytes, signature bigint) — mirrors helpers.rs:75-95."""
    return cert.tbs, cert.signature


def extract_public_key(issuer: Certificate) -> int:
    """Issuer's RSA modulus — mirrors helpers.rs:57-73."""
    return issuer.modulus


# ---------------------------------------------------------------------------
# PKCS#1 v1.5 / SHA-256 (host oracle for the RSA circuit)
# ---------------------------------------------------------------------------

# DigestInfo prefix for SHA-256 (RFC 8017 §9.2 note 1)
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def pkcs1v15_sha256_em(digest: bytes, k_bytes: int) -> int:
    """EM = 0x00 01 FF..FF 00 || DigestInfo || H as an integer."""
    t = SHA256_DIGEST_INFO + digest
    ps_len = k_bytes - 3 - len(t)
    if ps_len < 8:
        raise ValueError("modulus too small")
    em = b"\x00\x01" + b"\xff" * ps_len + b"\x00" + t
    return int.from_bytes(em, "big")


def verify_pkcs1v15_sha256(tbs: bytes, signature: int, modulus: int,
                           exponent: int = 65537) -> bool:
    """Host ground truth for the RSA circuit (reference behavior:
    halo2-rsa `verify_pkcs1v15_signature` [dep] Cargo.lock:1238)."""
    k_bytes = (modulus.bit_length() + 7) // 8
    em = pow(signature, exponent, modulus)
    expected = pkcs1v15_sha256_em(hashlib.sha256(tbs).digest(), k_bytes)
    return em == expected


# ---------------------------------------------------------------------------
# TLS chain download (reference helpers.rs:33-55)
# ---------------------------------------------------------------------------

def download_tls_certs_from_domain(domain: str, out_dir: str,
                                   port: int = 443, timeout: float = 10.0):
    """Fetch the chain a server presents and write it as cert_{i}.pem files
    in `out_dir`, the root-most as cert_1 and the leaf as the last (the
    reference writes cert_{3-i}.pem, leaf 3, helpers.rs:46-54).  Returns
    the paths, leaf first.

    The chain is the one the server sends: the ssl module gives no verified
    chain, where the reference takes openssl's; for a well-formed server
    they are the same certificates.
    """
    ctx = ssl.create_default_context()
    with socket.create_connection((domain, port), timeout=timeout) as sock:
        with ctx.wrap_socket(sock, server_hostname=domain) as tls:
            if hasattr(tls, "get_unverified_chain"):
                chain = tls.get_unverified_chain() or []
                certs_der = [c.public_bytes(ssl._ssl.ENCODING_DER)
                             if hasattr(c, "public_bytes") else c
                             for c in chain]
            else:
                certs_der = [tls.getpeercert(binary_form=True)]
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, der in enumerate(certs_der):
        b64 = base64.encodebytes(der).replace(b"\n", b"")
        lines = [b64[j:j + 64] for j in range(0, len(b64), 64)]
        pem = (b"-----BEGIN CERTIFICATE-----\n" + b"\n".join(lines)
               + b"\n-----END CERTIFICATE-----\n")
        path = f"{out_dir}/cert_{len(certs_der) - i}.pem"
        with open(path, "wb") as f:
            f.write(pem)
        paths.append(path)
    return paths
