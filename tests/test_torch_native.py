"""The port's host runtime (halo2_zkcert_tpu_torch/native.py over
csrc/hostmath.cpp) against its plain versions and the JAX package.

The native Poseidon permutation equals the port's `permute_plain` and the
JAX package's Python permutation on 1000 seeded states (0, 1 and p - 1
among them); the native Keccak-256 equals the port's and the JAX package's
`refcrypto.keccak256` at the rate's edges; the committed proofs verify
through the port's verifier on the native transcripts; and a library that
does not build raises, with no fallback to Python.
"""
import os

import numpy as np
import pytest

from halo2_zkcert_tpu.transcript import poseidon as jposeidon
from halo2_zkcert_tpu.utils import refcrypto as jrc
from halo2_zkcert_tpu_torch import native
from halo2_zkcert_tpu_torch.plonk.kzg import ParamsKZG, _default_tau
from halo2_zkcert_tpu_torch.plonk.verifier import verify_proof
from halo2_zkcert_tpu_torch.sdk import Snark, read_vk
from halo2_zkcert_tpu_torch.transcript import (PoseidonTranscript, _keccak,
                                               poseidon)
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KECCAK_LENGTHS = (0, 1, 135, 136, 137, 1000)


def _states(count: int, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    out = [[0, 0, 0], [1, 1, 1], [rc.FR - 1] * 3, [0, 1, rc.FR - 1]]
    while len(out) < count:
        out.append([int.from_bytes(rng.bytes(32), "little") % rc.FR
                    for _ in range(poseidon.T)])
    return out


def test_poseidon_native_equals_plain():
    for s in _states(1000):
        assert native.poseidon_permute(s) == poseidon.permute_plain(s)


def test_poseidon_equals_jax_python_permutation(monkeypatch):
    from halo2_zkcert_tpu import native as jnative
    monkeypatch.setattr(jnative, "AVAILABLE", False)   # the Python body
    for s in _states(50, seed=8):
        assert poseidon.permute(s) == jposeidon.permute(s)


def test_permute_dispatches_to_the_host_library(monkeypatch):
    calls = []
    monkeypatch.setattr(native, "poseidon_permute",
                        lambda s: calls.append(s) or [0, 0, 0])
    assert poseidon.permute([1, 2, 3]) == [0, 0, 0] and calls == [[1, 2, 3]]
    # another modulus runs the plain version
    p = 2 ** 61 - 1
    assert poseidon.permute([1, 2, 3], p) == poseidon.permute_plain([1, 2, 3],
                                                                    p)
    assert len(calls) == 1


def test_poseidon_reduces_its_input():
    s = [rc.FR + 5, -1, (1 << 256) - 1]
    assert native.poseidon_permute(s) == poseidon.permute_plain(
        [v % rc.FR for v in s])
    with pytest.raises(ValueError):
        native.poseidon_permute([1, 2])


@pytest.mark.parametrize("length", KECCAK_LENGTHS)
def test_keccak_equals_plain_and_jax(length):
    data = np.random.default_rng(length).bytes(length)
    got = native.keccak256(data)
    assert got == rc.keccak256(data) == jrc.keccak256(data)
    assert _keccak(data) == got


def _verify_committed(name: str) -> tuple:
    vk = read_vk(os.path.join(ROOT, "build", f"{name}.pk.vk"))
    snark = Snark.read(os.path.join(ROOT, "build", f"{name}.proof"))
    g2 = (rc.G2_GEN_X, rc.G2_GEN_Y)
    # the verifier reads only the G2 points of the SRS
    params = ParamsKZG(vk.k, None, None, g2, rc.g2_mul_affine(g2,
                                                              _default_tau()))
    ok = verify_proof(params, vk, snark.instances, snark.proof,
                      PoseidonTranscript)
    bad = bytearray(snark.proof)
    bad[-40] ^= 1
    rejected = not verify_proof(params, vk, snark.instances, bytes(bad),
                                PoseidonTranscript)
    return ok, rejected


@pytest.mark.parametrize("name", ["rsa_1", "sha256_1"])
def test_committed_proof_verifies_on_the_native_transcript(name):
    assert _verify_committed(name) == (True, True)


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"])
def test_a_failed_build_raises(monkeypatch, tmp_path, compiler):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", compiler)
    with pytest.raises(RuntimeError, match="host library build failed"):
        native.keccak256(b"abc")
    with pytest.raises(RuntimeError, match="host library build failed"):
        poseidon.permute([1, 2, 3])
    assert not list(tmp_path.glob("*.so"))


def test_the_library_is_named_by_its_source(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    path = native.build()
    assert path.parent == tmp_path and path.exists()
    assert path.name.startswith("libhostmath_")
    assert native.keccak256(b"") == rc.keccak256(b"")
    assert native.build() == path          # reused, not rebuilt
