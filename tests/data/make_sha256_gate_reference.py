"""Write tests/data/sha256_gate_reference.npz: the JAX package's key and
proof of the gate-level SHA-256 circuit at a short message, which the port
is held to.

    JAX_PLATFORMS=cpu python tests/data/make_sha256_gate_reference.py

`Sha256GateCircuit(b"abc", k=15)`: 396 010 cells packed into 13 advice
columns, the constraint system of the 970-byte circuit at k=19.  The JAX
package's `keygen` on `setup(15)`, then one proof with the Poseidon
transcript from the default blinding seed.  About 80 minutes on an 8-core
CPU, nearly all of it in the JAX package's variable-base MSM (some 60
commitments of 2^15 points).

The proof takes the JAX package's dispatch-per-op multiopen
(H2T_MULTIOPEN=eager, byte-identical to the fused one:
tests/test_plonk_e2e.py:146-154): XLA's CPU compiler crashes (SIGSEGV)
compiling the fused multiopen program of this circuit
(halo2_zkcert_tpu/plonk/shplonk.py:298), in two runs out of two.

The slow test
tests/test_torch_sha256_gate.py::test_reference_fixture_is_current
regenerates these and compares.
"""
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "sha256_gate_reference.npz")
MSG = b"abc"
K = 15


def reference() -> dict:
    """The arrays of the fixture, computed with the JAX package."""
    root = os.path.dirname(os.path.dirname(HERE))
    if root not in sys.path:
        sys.path.insert(0, root)
    from halo2_zkcert_tpu.circuits.sha256_gate import Sha256GateCircuit
    from halo2_zkcert_tpu.plonk import create_proof, keygen, setup
    from halo2_zkcert_tpu.sdk import _vk_to_dict
    from halo2_zkcert_tpu.transcript import PoseidonTranscript

    t0 = time.perf_counter()
    circ = Sha256GateCircuit(MSG, k=K)
    print(f"circuit {time.perf_counter() - t0:.1f} s", flush=True)
    params = setup(K)
    print(f"setup {time.perf_counter() - t0:.1f} s", flush=True)
    pk = keygen(params, circ.data)
    print(f"keygen {time.perf_counter() - t0:.1f} s", flush=True)
    saved = os.environ.get("H2T_MULTIOPEN")
    os.environ["H2T_MULTIOPEN"] = "eager"
    try:
        proof = create_proof(params, pk, circ.advice, circ.instances,
                             PoseidonTranscript())
    finally:
        if saved is None:
            del os.environ["H2T_MULTIOPEN"]
        else:
            os.environ["H2T_MULTIOPEN"] = saved
    print(f"proof {time.perf_counter() - t0:.1f} s", flush=True)
    return {
        "vk_json": np.frombuffer(json.dumps(_vk_to_dict(pk.vk)).encode(),
                                 np.uint8),
        "instances_json": np.frombuffer(json.dumps(circ.instances).encode(),
                                        np.uint8),
        "proof_poseidon": np.frombuffer(proof, np.uint8),
    }


if __name__ == "__main__":
    np.savez_compressed(OUT, **reference())
    print("wrote", OUT)
