"""Write tests/data/sha256_reference.npz: the JAX package's SHA-256 circuit
key, witness and proof at a short message, which the port's fast tests are
held against.

    JAX_PLATFORMS=cpu python tests/data/make_sha256_reference.py

The message is the first 101 bytes of the TBS of
testdata/example_cert_3.pem: two SHA-256 blocks, a boundary word pinned
byte by byte, k=9.  The JAX package's `sdk.gen_pk` on `setup(9)`, then one
proof with the Poseidon transcript from the default blinding seed.  The slow
test tests/test_torch_sha256.py::test_reference_fixture_is_current
regenerates these and compares.
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "sha256_reference.npz")
PK_ARRAYS = ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff")
MSG_LEN = 101


def message() -> bytes:
    """The first MSG_LEN bytes of example_cert_3's TBS."""
    root = os.path.dirname(os.path.dirname(HERE))
    if root not in sys.path:
        sys.path.insert(0, root)
    from halo2_zkcert_tpu.cert import extract_tbs_and_sig, parse_pem
    with open(os.path.join(root, "testdata", "example_cert_3.pem"), "rb") as f:
        tbs, _ = extract_tbs_and_sig(parse_pem(f.read()))
    return tbs[:MSG_LEN]


def reference() -> dict:
    """The arrays of the fixture, computed with the JAX package."""
    msg = message()
    from halo2_zkcert_tpu.circuits.sha256 import Sha256Circuit
    from halo2_zkcert_tpu.plonk import create_proof, setup
    from halo2_zkcert_tpu.sdk import _vk_to_dict, gen_pk
    from halo2_zkcert_tpu.transcript import PoseidonTranscript

    circuit = Sha256Circuit.build(len(msg))
    params = setup(circuit.data.k)
    pk = gen_pk(params, circuit.data)
    advice, instances = circuit.witness(msg)
    out = {k: np.asarray(getattr(pk, k)).astype(np.int32) for k in PK_ARRAYS}
    out["advice"] = np.asarray(advice).astype(np.int32)
    out["vk_json"] = np.frombuffer(json.dumps(_vk_to_dict(pk.vk)).encode(),
                                   np.uint8)
    out["instances_json"] = np.frombuffer(json.dumps(instances).encode(),
                                          np.uint8)
    proof = create_proof(params, pk, advice, instances, PoseidonTranscript())
    out["proof_poseidon"] = np.frombuffer(proof, np.uint8)
    return out


if __name__ == "__main__":
    np.savez_compressed(OUT, **reference())
    print("wrote", OUT)
