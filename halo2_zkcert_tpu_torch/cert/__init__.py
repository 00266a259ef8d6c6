"""X.509 certificate handling (host): the three extractions the proving
pipeline needs, and the download of a server's chain."""
from .x509 import (
    Certificate,
    download_tls_certs_from_domain,
    extract_public_key,
    extract_tbs_and_sig,
    parse_pem,
    pkcs1v15_sha256_em,
    verify_pkcs1v15_sha256,
)
