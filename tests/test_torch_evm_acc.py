"""The EVM verifier's fold of a deferred KZG accumulator (the `comb128` and
`final_acc` ops), on the CPU.

The accumulator toy (tests/data/make_evm_reference.py `acc_toy`: the toy
circuit at k=6 whose 8 instance rows are the 128-bit limbs of an
accumulator pair, `accumulator_indices` on them) is keyed and proved with
the port's `sdk.gen_evm_proof` (the Keccak transcript) for the pair
(P, tau P), which passes the deferred pairing.  The port's `evm_verify` and
`execute_ir` accept the proof, the JAX package's `execute_ir` and
`evm_verify_bytecode` accept the same bytes with the same gas, and
`sdk.gen_evm_verifier` writes the JAX package's Solidity for its vk.  The
proof of a pair that fails the pairing is checked on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import os
import sys

import pytest
import torch

from halo2_zkcert_tpu import evm as jevm
from halo2_zkcert_tpu.sdk import _vk_from_dict as jvk_from_dict
from halo2_zkcert_tpu_torch import evm, sdk
from halo2_zkcert_tpu_torch.circuits.aggregation import decode_accumulator
from halo2_zkcert_tpu_torch.plonk import keygen, setup
from halo2_zkcert_tpu_torch.plonk.keygen import vk_to_dict

torch.set_num_threads(2)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data"))
import make_evm_reference as ref  # noqa: E402


@pytest.fixture(scope="module")
def acc():
    pair = ref.acc_pair(True)
    data, advice, instances = ref.acc_toy(pair, "cpu")
    params = setup(data.k, device="cpu")
    pk = keygen(params, data)
    proof = sdk.gen_evm_proof(params, pk, advice, instances)
    return dict(pair=pair, params=params, vk=pk.vk, instances=instances,
                proof=proof, jvk=jvk_from_dict(vk_to_dict(pk.vk)))


def test_instances_hold_the_pair(acc):
    assert decode_accumulator(acc["instances"]) == acc["pair"]
    assert acc["vk"].accumulator_indices == [(0, i) for i in range(8)]
    ops, proof_len = evm.build_verifier_ir(acc["vk"], [8])
    assert proof_len == len(acc["proof"])
    assert [op[0] for op in ops].count("comb128") == 4
    assert ops[-1][0] == "final_acc"


def test_port_evm_and_ir_accept(acc):
    p, vk, inst, proof = acc["params"], acc["vk"], acc["instances"], \
        acc["proof"]
    assert sdk.evm_verify(p, vk, inst, proof)
    ops, _ = evm.build_verifier_ir(vk, [8])
    assert evm.execute_ir(ops, inst, proof, p)


def test_jax_evm_and_ir_accept_the_same_bytes(acc):
    p, inst, proof = acc["params"], acc["instances"], acc["proof"]
    got = evm.evm_verify_bytecode(p, acc["vk"], inst, proof)
    assert got[0]
    assert jevm.evm_verify_bytecode(p, acc["jvk"], inst, proof) == got
    jops, _ = jevm.build_verifier_ir(acc["jvk"], [8])
    assert jevm.execute_ir(jops, inst, proof, p)


def test_solidity_equals_jax(acc, tmp_path):
    path = str(tmp_path / "Acc.sol")
    src = sdk.gen_evm_verifier(acc["params"], acc["vk"], [8], path)
    with open(path) as f:
        assert f.read() == src
    assert src == jevm.gen_evm_verifier(acc["params"], acc["jvk"], [8])
