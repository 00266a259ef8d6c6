"""Write tests/data/toy_reference.npz: the JAX package's toy-circuit proving
key, witness and proofs, which the port's fast tests are held against.

    JAX_PLATFORMS=cpu python tests/data/make_toy_reference.py

The toy circuit is tests/test_plonk_e2e.py's `build_toy` (k=6): keygen on
`setup(6)`, then one proof with the Poseidon and one with the Keccak
transcript, both from the default blinding seed.  The slow test
tests/test_torch_prover.py::test_reference_fixture_is_current regenerates
these and compares.
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "toy_reference.npz")
PK_ARRAYS = ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff")


def reference() -> dict:
    """The arrays of the fixture, computed with the JAX package."""
    tests = os.path.dirname(HERE)
    for d in (tests, os.path.dirname(tests)):
        if d not in sys.path:
            sys.path.insert(0, d)
    from test_plonk_e2e import K, build_toy
    from halo2_zkcert_tpu.plonk import create_proof, keygen, setup
    from halo2_zkcert_tpu.sdk import _vk_to_dict
    from halo2_zkcert_tpu.transcript import KeccakTranscript, PoseidonTranscript

    data, advice, instances = build_toy()
    params = setup(K)
    pk = keygen(params, data)
    out = {k: np.asarray(getattr(pk, k)).astype(np.int32) for k in PK_ARRAYS}
    out["advice"] = np.asarray(advice).astype(np.int32)
    out["vk_json"] = np.frombuffer(json.dumps(_vk_to_dict(pk.vk)).encode(),
                                   np.uint8)
    out["instances_json"] = np.frombuffer(json.dumps(instances).encode(),
                                          np.uint8)
    for name, cls in (("poseidon", PoseidonTranscript),
                      ("keccak", KeccakTranscript)):
        proof = create_proof(params, pk, advice, instances, cls())
        out[f"proof_{name}"] = np.frombuffer(proof, np.uint8)
    return out


if __name__ == "__main__":
    np.savez_compressed(OUT, **reference())
    print("wrote", OUT)
