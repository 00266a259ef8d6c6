"""X.509 certificate handling (host): the three extractions the proving
pipeline needs."""
from .x509 import (
    Certificate,
    extract_public_key,
    extract_tbs_and_sig,
    parse_pem,
    pkcs1v15_sha256_em,
    verify_pkcs1v15_sha256,
)
