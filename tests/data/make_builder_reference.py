"""Write tests/data/builder_reference.npz: the JAX package's key and proof
of the vertical-gate builder's sample circuit, which the port is held to.

    JAX_PLATFORMS=cpu python tests/data/make_builder_reference.py

The sample is `build_sample` below, the circuit of tests/test_builder.py
(a product, a difference range-checked in two 7-bit chunks through a
lookup, an is-zero, an inner product, two public values) at k=8: the JAX
package's `keygen` on `setup(8)`, then one proof with the Poseidon
transcript from the default blinding seed, and the JAX MockProver's
verdict on the witness with advice cell CORRUPT's value plus one.  About 6
minutes on an 8-core CPU.  The slow test
tests/test_torch_builder.py::test_reference_fixture_is_current regenerates
these and compares.
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "builder_reference.npz")
K = 8
CORRUPT = (0, 5)          # (advice column, row) whose value gains one


def build_sample(builder_cls, x_val: int = 12, y_val: int = 45):
    """The sample trace on a `GateBuilder` of either package."""
    gb = builder_cls(lookup_bits=7)
    x = gb.witness(x_val)
    y = gb.witness(y_val)
    z = gb.mul_add(x, y, gb.constant(5))
    w = gb.sub(z, x)
    gb.range_check(w, 14)
    b = gb.is_zero(gb.sub(x, y))
    gb.assert_const(b, 0 if x_val != y_val else 1)
    acc = gb.inner_product([x, y, z], [y, z, w])
    gb.expose_public(acc)
    gb.expose_public(w)
    return gb


def reference() -> dict:
    """The arrays of the fixture, computed with the JAX package."""
    root = os.path.dirname(os.path.dirname(HERE))
    if root not in sys.path:
        sys.path.insert(0, root)
    from halo2_zkcert_tpu.builder import GateBuilder
    from halo2_zkcert_tpu.plonk import create_proof, keygen, run_mock, setup
    from halo2_zkcert_tpu.sdk import _vk_to_dict
    from halo2_zkcert_tpu.transcript import PoseidonTranscript

    data, advice, instances = build_sample(GateBuilder).finalize(K)
    params = setup(K)
    pk = keygen(params, data)
    proof = create_proof(params, pk, advice, instances, PoseidonTranscript())
    bad = np.asarray(advice).copy()
    bad[CORRUPT[0], CORRUPT[1], 0] += 1
    mock = run_mock(data, bad, instances, raise_on_failure=False)
    return {
        "vk_json": np.frombuffer(json.dumps(_vk_to_dict(pk.vk)).encode(),
                                 np.uint8),
        "instances_json": np.frombuffer(json.dumps(instances).encode(),
                                        np.uint8),
        "proof_poseidon": np.frombuffer(proof, np.uint8),
        "mock_corrupted_json": np.frombuffer(json.dumps(mock).encode(),
                                             np.uint8),
    }


if __name__ == "__main__":
    np.savez_compressed(OUT, **reference())
    print("wrote", OUT)
