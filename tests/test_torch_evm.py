"""The port's EVM verifier path (halo2_zkcert_tpu_torch/evm/) against the
JAX package's, on the CPU.

* The interpreter: the known-answer programs of tests/test_evm_diff.py run
  through both packages' `Evm`, with the same success, output and gas.
* The IR, bytecode and Solidity: for the toy vk and the committed keys
  build/{rsa_1,rsa_2,sha256_1,sha256_2,x509_agg}.pk.vk, the port's op list,
  deployment bytecode and Solidity text equal the JAX package's exactly.
* The toy fixture's Keccak proof: accepted by the port's `execute_ir` and
  EVM with the JAX EVM's gas; a wrong instance, a flipped last byte and a
  proof cut short by 32 bytes are rejected by both packages.
* tests/data/evm_reference.json (what the card is held to) is what
  tests/data/make_evm_reference.py computes now.
"""
import json
import os
import sys

import pytest

from halo2_zkcert_tpu import evm as jevm
from halo2_zkcert_tpu.evm.interp import Evm as JEvm
from halo2_zkcert_tpu.sdk import _vk_from_dict as jvk_from_dict
from halo2_zkcert_tpu_torch import evm, sdk
from halo2_zkcert_tpu_torch.evm.interp import Evm
from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
from halo2_zkcert_tpu_torch.plonk.kzg import ParamsKZG
from halo2_zkcert_tpu_torch.utils import refcrypto as rc
from test_evm_diff import (ADDMOD, CALLDATALOAD, CALLDATASIZE, CODECOPY,
                           DIV, EQ, GT, ISZERO, JUMP, JUMPDEST, JUMPI,
                           KECCAK256, LT, MLOAD, MSTORE, MUL, MULMOD, PUSH0,
                           PUSH1, RETURN, REVERT, SHL, SHR, STOP, SUB, ADD,
                           G1, U256, _Q, _aff_mul, _static, push, ret_top)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
sys.path.insert(0, DATA)
import make_evm_reference as ref  # noqa: E402

FR = rc.FR
G2_EVM = (  # EIP-197 order: x.c1, x.c0, y.c1, y.c0
    0x198E9393920D483A7260BFB731FB5D25F1AA493335A9E71297E485B7AEF312C2,
    0x1800DEEF121F1E76426A00665E5C4479674322D4F75EDADD46DEBD5CD992F6ED,
    0x090689D0585FF075EC9E99AD690C3395BC4B313370B38EF355ACDADCD122975B,
    0x12C85EA5DB8C6DEB4AAB71808DCB408FE3D1E7690C43D37B4CE6CC0166FA7DAA)


def _w(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _pairing_input(pairs) -> bytes:
    return b"".join(_w(p[0]) + _w(p[1]) + b"".join(_w(v) for v in G2_EVM)
                    for p in pairs)


# name -> [(code, calldata, the 32-byte word it returns, or None where the
# call must fail)]
def _cases():
    p = FR
    a, b = p - 3, p - 5
    data = _w(11) + _w(22)
    tail = bytes([JUMPDEST]) + push(7) + ret_top()
    kg = _aff_mul(G1, 0xDECAFBAD)
    two_g = _aff_mul(G1, 2)
    neg_g1 = (G1[0], _Q - G1[1])
    runtime = push(42) + ret_top()
    n = len(runtime)
    ctor = bytes([PUSH1, n, PUSH1, 10, PUSH0, CODECOPY, PUSH1, n, PUSH0,
                  RETURN])
    return {
        "arithmetic": [
            (push(2) + push(2) + push(6) + push(5) + push(7)
             + bytes([ADD, MUL, SUB, DIV]) + ret_top(), b"", 35),
            (push(2) + push(U256 - 1) + bytes([ADD]) + ret_top(), b"", 1),
            (push(5) + push(3) + bytes([SUB]) + ret_top(), b"",
             (3 - 5) % U256),
            (push(0) + push(7) + bytes([DIV]) + ret_top(), b"", 0)],
        "addmod_mulmod": [
            (push(p) + push(b) + push(a) + bytes([ADDMOD]) + ret_top(), b"",
             (a + b) % p),
            (push(p) + push(b) + push(a) + bytes([MULMOD]) + ret_top(), b"",
             a * b % p),
            (push(0) + push(b) + push(a) + bytes([MULMOD]) + ret_top(), b"",
             0)],
        "comparisons_shifts": [
            (push(y) + push(x) + bytes([op]) + ret_top(), b"", want)
            for op, x, y, want in ((LT, 3, 5, 1), (LT, 5, 3, 0),
                                   (GT, 5, 3, 1), (EQ, 9, 9, 1),
                                   (EQ, 9, 8, 0))] + [
            (push(0) + bytes([ISZERO]) + ret_top(), b"", 1),
            (push(7) + bytes([ISZERO]) + ret_top(), b"", 0),
            (push(5) + push(4) + bytes([SHL]) + ret_top(), b"", 80),
            (push(80) + push(4) + bytes([SHR]) + ret_top(), b"", 5)],
        "memory_calldata": [
            (push(32) + bytes([CALLDATALOAD]) + ret_top(), data, 22),
            (bytes([CALLDATASIZE]) + ret_top(), data, 64),
            (push(0xDEADBEEF) + push(0x200) + bytes([MSTORE]) + push(0x200)
             + bytes([MLOAD]) + ret_top(), b"", 0xDEADBEEF),
            (push(4096) + bytes([CALLDATALOAD]) + ret_top(), data, 0)],
        "keccak": [
            (push(0) + push(0) + bytes([KECCAK256]) + ret_top(), b"",
             0xc5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470),
            (push(0x616263) + push(0) + bytes([MSTORE]) + push(3) + push(29)
             + bytes([KECCAK256]) + ret_top(), b"",
             0x4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45)],
        "jumps_revert": [
            (bytes([PUSH1, 1, PUSH1, 8, JUMPI, PUSH0, PUSH0, REVERT]) + tail,
             b"", 7),
            (bytes([PUSH1, 0, PUSH1, 8, JUMPI, PUSH0, PUSH0, REVERT]) + tail,
             b"", None),
            (push(1) + bytes([JUMP, STOP]), b"", None)],
        "ecadd_ecmul": [
            (_static(0x06, (_w(G1[0]) + _w(G1[1])) * 2, 64), b"", two_g),
            (_static(0x07, _w(G1[0]) + _w(G1[1]) + _w(0xDECAFBAD), 64), b"",
             kg)],
        "modexp": [
            (_static(0x05, _w(1) + _w(1) + _w(1) + bytes([3, 7, 10]), 1), b"",
             "07")],
        "pairing": [
            (_static(0x08, _pairing_input([G1, neg_g1]), 32), b"", 1),
            (_static(0x08, _pairing_input([G1, G1]), 32), b"", 0)],
        "deploy": [(ctor + runtime, b"deploy", runtime)],
    }


CASES = _cases()


def _run(cls, code, calldata):
    m = cls()
    if calldata == b"deploy":
        dep = m.deploy(code)
        call = m.call(b"")
        return (dep.success, dep.output, dep.gas_used, m.runtime,
                call.success, call.output, call.gas_used)
    m.runtime = bytes(code)
    res = m.call(calldata)
    return res.success, res.output, res.gas_used


@pytest.mark.parametrize("name", sorted(CASES))
def test_interpreter_equals_jax_and_known_answers(name):
    for code, calldata, want in CASES[name]:
        got = _run(Evm, code, calldata)
        assert got == _run(JEvm, code, calldata), name
        if calldata == b"deploy":
            assert got[0] and got[3] == want and got[4]
            assert int.from_bytes(got[5], "big") == 42
        elif want is None:
            assert not got[0], name
        elif isinstance(want, tuple):
            assert got[0] and (int.from_bytes(got[1][:32], "big"),
                               int.from_bytes(got[1][32:], "big")) == want
        elif isinstance(want, str):
            assert got[0] and got[1] == bytes.fromhex(want)
        else:
            assert got[0] and int.from_bytes(got[1], "big") == want, name


@pytest.fixture(scope="module")
def params():
    """The G2 points of the JAX package's setup (the default tau); the
    EVM path reads nothing else of the SRS."""
    with open(os.path.join(DATA, "evm_reference.json")) as f:
        fx = json.load(f)
    g2, s_g2 = (tuple(tuple(int(v) for v in c) for c in fx[key])
                for key in ("g2", "s_g2"))
    assert g2 == (rc.G2_GEN_X, rc.G2_GEN_Y)
    from halo2_zkcert_tpu_torch.plonk.kzg import _default_tau
    assert s_g2 == rc.g2_mul_affine(g2, _default_tau())
    return ParamsKZG(4, None, None, g2, s_g2)


@pytest.fixture(scope="module")
def vk_dicts():
    return ref.vk_dicts()


@pytest.mark.parametrize("name", ["toy", *ref.VK_STEMS])
def test_ir_bytecode_solidity_equal_jax(name, vk_dicts, params):
    vk, jvk = vk_from_dict(vk_dicts[name]), jvk_from_dict(vk_dicts[name])
    rows = list(vk.num_instance)
    ops, proof_len = evm.build_verifier_ir(vk, rows)
    assert (ops, proof_len) == jevm.build_verifier_ir(jvk, rows)
    art = evm.gen_evm_verifier_bytecode(params, vk, rows)
    jart = jevm.gen_evm_verifier_bytecode(params, jvk, rows)
    assert art == jart
    assert art["deploy"] == evm.bytecode.deployment_code(art["runtime"])
    sol = evm.emit_solidity(vk, rows, ref.sol_name(name), params=params)
    assert sol == jevm.emit_solidity(jvk, rows, ref.sol_name(name),
                                     params=params)
    if vk.accumulator_indices:
        tags = [op[0] for op in ops]
        assert tags.count("comb128") == 4 and tags[-1] == "final_acc"


def test_solidity_file_written(vk_dicts, params, tmp_path):
    vk = vk_from_dict(vk_dicts["toy"])
    path = str(tmp_path / "Toy.sol")
    src = sdk.gen_evm_verifier(params, vk, [1], path, name="Toy")
    with open(path) as f:
        assert f.read() == src
    assert src == jevm.gen_evm_verifier(params, jvk_from_dict(
        vk_dicts["toy"]), [1], None, "Toy")


@pytest.fixture(scope="module")
def toy(vk_dicts):
    instances, proof = ref.toy_keccak()
    return (vk_from_dict(vk_dicts["toy"]), jvk_from_dict(vk_dicts["toy"]),
            instances, proof)


def _tampered(instances, proof):
    flipped = bytearray(proof)
    flipped[-1] ^= 1
    return {"wrong instance": ([[(instances[0][0] + 1) % FR]], proof),
            "flipped last byte": (instances, bytes(flipped)),
            "cut short by 32 bytes": (instances, proof[:-32])}


def test_toy_keccak_proof_accepted_with_the_jax_gas(toy, params):
    vk, jvk, instances, proof = toy
    with open(os.path.join(DATA, "evm_reference.json")) as f:
        want = json.load(f)["toy_keccak"]
    got = evm.evm_verify_bytecode(params, vk, instances, proof)
    assert got == jevm.evm_verify_bytecode(params, jvk, instances, proof)
    assert got == (want["accepted"], want["gas"]) == (True, 298470)
    assert sdk.evm_verify(params, vk, instances, proof)
    ops, proof_len = evm.build_verifier_ir(vk, [1])
    assert proof_len == len(proof)
    assert evm.execute_ir(ops, instances, proof, params)


@pytest.mark.parametrize("what", ["wrong instance", "flipped last byte",
                                  "cut short by 32 bytes"])
def test_toy_keccak_tampered_rejected(toy, params, what):
    vk, jvk, instances, proof = toy
    inst, bad = _tampered(instances, proof)[what]
    ok, gas = evm.evm_verify_bytecode(params, vk, inst, bad)
    assert not ok
    assert (ok, gas) == jevm.evm_verify_bytecode(params, jvk, inst, bad)
    ops, _ = evm.build_verifier_ir(vk, [1])
    if len(bad) == len(proof):
        assert not evm.execute_ir(ops, inst, bad, params)


def test_reference_fixture_is_current():
    with open(os.path.join(DATA, "evm_reference.json")) as f:
        assert json.load(f) == json.loads(json.dumps(ref.reference()))
