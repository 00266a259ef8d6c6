"""halo2_zkcert_tpu_torch — the PyTorch/CUDA port of halo2_zkcert_tpu.

A PLONKish/KZG prover over BN254 for X.509 certificate chains, with its
device work in PyTorch and hand-written CUDA kernels for Hopper (csrc/).
The JAX package stays the reference; this package imports nothing of it.

Package layout (the JAX package's, module for module):
  ops/        field (K1), curve (K2, K3), NTT, MSM, vector primitives
  plonk/      domain, KZG, constraint system, keys, quotient tape (K4),
              prover, SHPLONK, verifier
  circuits/   the RSA PKCS#1 v1.5 signature circuit
  transcript/ Poseidon and Keccak Fiat-Shamir transcripts (host)
  cert/       X.509 parsing (host)
  utils/      the Python-int BN254 oracle (host)

Entry points take a `device` and default to "cuda"; the tests pass "cpu".
"""

__version__ = "0.1.0"
