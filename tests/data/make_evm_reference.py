"""Write tests/data/evm_reference.json: the JAX package's EVM verifier
artifacts, which the port is held to where there is no JAX (on the card).

    JAX_PLATFORMS=cpu python tests/data/make_evm_reference.py

For the toy vk (tests/data/toy_reference.npz `vk_json`) and for
build/{rsa_1,rsa_2,sha256_1,sha256_2,x509_agg}.pk.vk, with the G2 points of
the JAX package's `setup(4)` (the default tau): the IR's op count, proof
length and blake2b, the runtime's size, the deployment bytecode's blake2b,
and the Solidity text's length and blake2b (contract `sol_name`).  For the
toy fixture's Keccak proof: the JAX EVM's verdict and gas.  Runs in
seconds; tests/test_torch_evm.py::test_reference_fixture_is_current
regenerates it and compares.

The module also holds the accumulator toy (`acc_toy`), built with the port
alone so that the card can build it: the toy circuit of
tests/test_plonk_e2e.py (k=6) whose instance column has 8 rows, the 128-bit
limbs of an accumulator pair (LHS, RHS), with `accumulator_indices` on
those rows.  `acc_pair(True)` is (P, tau P), which passes the deferred
pairing at the test SRS's tau; `acc_pair(False)` is (P, (tau + 1) P),
which does not.
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "evm_reference.json")
VK_STEMS = ("rsa_1", "rsa_2", "sha256_1", "sha256_2", "x509_agg")
# the contract name each vk's Solidity is emitted with: the aggregation's
# as the CLI's gen-x509-agg-evm-proof names it, the rest gen_evm_verifier's
# default
SOL_NAMES = {"x509_agg": "X509AggregationVerifierFinal"}
SOL_DEFAULT = "Halo2TpuVerifier"
ACC_K = 6
ACC_SCALAR = 5                       # P = 5 G


def toy_vk_dict() -> dict:
    z = np.load(os.path.join(HERE, "toy_reference.npz"))
    return json.loads(z["vk_json"].tobytes())


def toy_keccak() -> tuple:
    """(instances, proof) of the toy fixture's Keccak proof."""
    z = np.load(os.path.join(HERE, "toy_reference.npz"))
    return (json.loads(z["instances_json"].tobytes()),
            z["proof_keccak"].tobytes())


def vk_dicts() -> dict:
    """name -> vk dict: the toy's and the committed keys'."""
    out = {"toy": toy_vk_dict()}
    for stem in VK_STEMS:
        with open(os.path.join(ROOT, "build", f"{stem}.pk.vk")) as f:
            out[stem] = json.load(f)
    return out


def sol_name(name: str) -> str:
    return SOL_NAMES.get(name, SOL_DEFAULT)


def artifact_record(evm, rc, params, vk, name: str) -> dict:
    """The digests of one vk's IR, bytecode and Solidity, through `evm`
    (either package's evm module) and `rc` (its refcrypto)."""
    rows = list(vk.num_instance)
    ops, proof_len = evm.build_verifier_ir(vk, rows)
    art = evm.gen_evm_verifier_bytecode(params, vk, rows)
    sol = evm.emit_solidity(vk, rows, sol_name(name), params=params)
    return {"num_ops": len(ops), "proof_len": proof_len,
            "ops_blake2b": rc.blake2b(json.dumps(ops).encode(), 32).hex(),
            "runtime_len": len(art["runtime"]),
            "deploy_blake2b": rc.blake2b(art["deploy"], 32).hex(),
            "sol_len": len(sol),
            "sol_blake2b": rc.blake2b(sol.encode(), 32).hex()}


def reference() -> dict:
    """The fixture, computed with the JAX package."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from halo2_zkcert_tpu import evm
    from halo2_zkcert_tpu.plonk import setup
    from halo2_zkcert_tpu.sdk import _vk_from_dict
    from halo2_zkcert_tpu.utils import refcrypto as rc
    params = setup(4)
    out = {"g2": [[str(v) for v in c] for c in params.g2],
           "s_g2": [[str(v) for v in c] for c in params.s_g2], "vks": {}}
    vks = {name: _vk_from_dict(d) for name, d in vk_dicts().items()}
    for name, vk in vks.items():
        out["vks"][name] = artifact_record(evm, rc, params, vk, name)
    instances, proof = toy_keccak()
    accepted, gas = evm.evm_verify_bytecode(params, vks["toy"], instances,
                                            proof)
    out["toy_keccak"] = {"accepted": accepted, "gas": gas}
    return out


def acc_pair(good: bool) -> tuple:
    """((lhs_x, lhs_y), (rhs_x, rhs_y)): P and tau P (or (tau + 1) P)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from halo2_zkcert_tpu_torch.plonk.kzg import _default_tau
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    G = rc.g1_from_affine(rc.G1_GEN)
    P = rc.g1_mul(G, ACC_SCALAR)
    s = _default_tau() + (0 if good else 1)
    return rc.g1_to_affine(P), rc.g1_to_affine(rc.g1_mul(P, s))


def acc_toy(pair: tuple, device):
    """-> (CircuitData, advice (3, n, 8) on `device`, instances) of the
    accumulator toy for `pair` (see the module docstring)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from halo2_zkcert_tpu_torch.ops import field
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.plonk import (ADVICE, INSTANCE, CircuitData,
                                              Column, ConstraintSystem)
    from halo2_zkcert_tpu_torch.transcript import LIMB_BITS, fe_to_limbs
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    n = 1 << ACC_K
    cs = ConstraintSystem()
    q = cs.fixed_column()        # gate selector
    tbl = cs.fixed_column()      # lookup table column (values 0..15)
    a = cs.advice_column()
    b = cs.advice_column()
    c = cs.advice_column()
    pi = cs.instance_column()
    cs.create_gate("mul_add", q * (a * b + a - c))
    cs.add_lookup("a_in_table", [(a, tbl)])
    for col in (Column(ADVICE, a.index), Column(ADVICE, b.index),
                Column(ADVICE, c.index), Column(INSTANCE, pi.index)):
        cs.enable_permutation(col)
    fixed = np.array([[1 if i < 32 else 0 for i in range(n)],
                      [i % 16 for i in range(n)]], dtype=object)
    (lx, ly), (rx, ry) = pair
    limbs = [v for coord in (lx, ly, rx, ry)
             for v in fe_to_limbs(coord, 2, LIMB_BITS)]
    a_vals = [i % 16 for i in range(n)]
    b_vals = [(i * 3) % 16 for i in range(n)]
    b_vals[7] = a_vals[2]        # the copy a[2] == b[7]
    b_vals[1] = (limbs[0] - 1) % rc.FR     # a[1] = 1, so c[1] = limbs[0]
    c_vals = [(a_vals[i] * b_vals[i] + a_vals[i]) % rc.FR for i in range(n)]
    assert c_vals[1] == limbs[0]
    copies = [((ADVICE, c.index, 1), (INSTANCE, pi.index, 0)),
              ((ADVICE, a.index, 2), (ADVICE, b.index, 7))]
    data = CircuitData(cs=cs, k=ACC_K, fixed=fixed, copies=copies,
                       num_instance=[8],
                       accumulator_indices=[(0, i) for i in range(8)])
    advice = torch.stack([field.from_ints(FR, vals, device)
                          for vals in (a_vals, b_vals, c_vals)])
    return data, advice, [limbs]


if __name__ == "__main__":
    with open(OUT, "w") as f:
        json.dump(reference(), f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", OUT)
