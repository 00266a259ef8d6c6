"""Write tests/data/aggregation_reference.npz: the JAX package's aggregation
circuits, which the port's are held to.

    JAX_PLATFORMS=cpu python tests/data/make_aggregation_reference.py

It holds
- the toy inner snarks of tests/test_aggregation.py (k=6, the Poseidon
  transcript, the default blinding seed): `_toy_inner_snark` ("toy") and
  `_toy_inner_snark_const` with c = 5 and c = 7 ("c5", "c7"), each as its
  vk (json), instances (json) and proof bytes;
- for the JAX package's `AggregationCircuit` at k=19, lanes 4, na 2, nl 1
  in fixed-vk mode over "toy" ("agg_toy") and in universal mode over "c5"
  and over "c7" ("agg_c5", "agg_c7"), and for
  `X509VerifierAggregationCircuit` at k=20, lanes 8, na 8, nl 1 over the
  four committed inner snarks build/{rsa_1,sha256_1,rsa_2,sha256_2}.proof
  ("x509"), a json record (`circuit_record`): the constraint system
  (`to_dict`), the cache digest, a digest of every fixed column, of the
  copies, the instances, and digests of every phase-0 and phase-1 advice
  column at tau = the MockProver's challenge (`mock_challenges(cs)[0]`).

A digest is blake2b (16 bytes) of the values as 32-byte little-endian
words, row after row; the copies' of an (m, 2, 3) int64 array of (kind
code, column, row) with advice 0, fixed 1, instance 2.  About 12 minutes on
an 8-core CPU, most of it the k=20 circuit's two passes.  The slow test
tests/test_torch_aggregation.py::test_reference_fixture_is_current
regenerates these and compares.
"""
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "aggregation_reference.npz")
ROOT = os.path.dirname(os.path.dirname(HERE))
K_AGG, LANES_AGG, NA_AGG = 19, 4, 2
K_X509, LANES_X509, NA_X509 = 20, 8, 8
X509_STEMS = ("rsa_1", "sha256_1", "rsa_2", "sha256_2")
COPY_CODES = {"advice": 0, "fixed": 1, "instance": 2}


def digest(raw: bytes) -> str:
    return hashlib.blake2b(raw, digest_size=16).hexdigest()


def words_digest(words) -> str:
    """Digest of (..., 8) canonical words (a numpy array or a CPU tensor):
    the same bytes as the values' 32-byte little-endian words."""
    return digest(np.ascontiguousarray(np.asarray(words), dtype="<i4")
                  .tobytes())


def load_record(name: str) -> dict:
    """A circuit's json record from the committed fixture."""
    with np.load(OUT) as z:
        return json.loads(z[f"{name}_json"].tobytes())


def int_column_bytes(values) -> bytes:
    """Field ints -> their 32-byte little-endian words, concatenated."""
    return b"".join(int(v).to_bytes(32, "little") for v in values)


def copies_array(copies) -> np.ndarray:
    flat = [v for a, b in copies
            for v in (COPY_CODES[a[0]], a[1], a[2], COPY_CODES[b[0]], b[1],
                      b[2])]
    return np.asarray(flat, dtype="<i8").reshape(-1, 2, 3)


def _jax():
    for d in (ROOT, os.path.join(ROOT, "tests")):
        if d not in sys.path:
            sys.path.insert(0, d)


def circuit_record(circ) -> dict:
    """The json record of a JAX aggregation circuit (module docstring)."""
    _jax()
    from halo2_zkcert_tpu.plonk.mock import mock_challenges
    data = circ.data
    tau = mock_challenges(data.cs)[0]
    witness_fn, instances = circ.witness()

    def advice(phase, ch):
        # canonical 8-bit limbs; the first 32 are the value's LE bytes
        return {str(i): digest(np.asarray(v)[:, :32].astype(np.uint8)
                               .tobytes())
                for i, v in sorted(witness_fn(phase, ch).items())}

    return {
        "cs": data.cs.to_dict(),
        "cache_digest": data.cache_digest_bytes().hex(),
        "fixed": [digest(int_column_bytes(col)) for col in data.fixed],
        "copies": digest(copies_array(data.copies).tobytes()),
        "num_copies": len(data.copies),
        "instances": [[str(int(v)) for v in col] for col in instances],
        "tau": str(tau),
        "phase0": advice(0, {}),
        "phase1": advice(1, {0: tau}),
        "rows": circ.rows_report(),
    }


def _snark_arrays(name: str, snark) -> dict:
    from halo2_zkcert_tpu.sdk import _vk_to_dict
    return {
        f"{name}_vk_json": np.frombuffer(
            json.dumps(_vk_to_dict(snark.vk)).encode(), np.uint8),
        f"{name}_instances_json": np.frombuffer(
            json.dumps([[int(v) for v in c] for c in snark.instances])
            .encode(), np.uint8),
        f"{name}_proof": np.frombuffer(snark.proof, np.uint8),
    }


def _record_array(rec: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(rec).encode(), np.uint8)


def reference() -> dict:
    """The arrays of the fixture, computed with the JAX package."""
    _jax()
    from test_aggregation import _toy_inner_snark, _toy_inner_snark_const
    from halo2_zkcert_tpu import sdk
    from halo2_zkcert_tpu.circuits.aggregation import (AggregationCircuit,
                                                       InnerSnark)
    from halo2_zkcert_tpu.circuits.x509_agg import \
        X509VerifierAggregationCircuit

    out = {}
    snarks = {"toy": _toy_inner_snark()[0],
              "c5": _toy_inner_snark_const(5)[0],
              "c7": _toy_inner_snark_const(7)[0]}
    for name, snark in snarks.items():
        out.update(_snark_arrays(name, snark))
    for name, inner, universal in (("agg_toy", "toy", False),
                                   ("agg_c5", "c5", True),
                                   ("agg_c7", "c7", True)):
        circ = AggregationCircuit([snarks[inner]], k=K_AGG, lanes=LANES_AGG,
                                  na=NA_AGG, nl=1, universal=universal)
        out[f"{name}_json"] = _record_array(circuit_record(circ))
    inner = []
    for stem in X509_STEMS:
        s = sdk.Snark.read(os.path.join(ROOT, "build", f"{stem}.proof"))
        inner.append(InnerSnark(vk=s.vk, instances=s.instances,
                                proof=s.proof))
    circ = X509VerifierAggregationCircuit(inner, k=K_X509, lanes=LANES_X509,
                                          na=NA_X509)
    out["x509_json"] = _record_array(circuit_record(circ))
    return out


if __name__ == "__main__":
    np.savez_compressed(OUT, **reference())
    print("wrote", OUT)
