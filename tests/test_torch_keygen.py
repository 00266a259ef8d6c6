"""The port's keygen and key files against the JAX package.

`keygen` of the toy circuit (tests/test_plonk_e2e.py `build_toy`, k=6) on
the CPU equals the JAX key in tests/data/toy_reference.npz: every column,
the vk commitments and the vk's transcript hash.  The RSA k=17 circuit's
`cache_digest_bytes()` equals the digest the JAX package wrote beside
build/rsa_1.pk.  A pk written by either package is read by the other's
`read_pk` with equal columns, and `gen_pk` takes a saved key only when it
was made from the same circuit.
"""
import json
import os

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch import sdk
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.plonk import (CircuitData, from_reference_pk,
                                          keygen, setup)
from halo2_zkcert_tpu_torch.plonk.cs import ConstraintSystem
from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict, vk_to_dict
from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
from test_plonk_e2e import build_toy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "toy_reference.npz")
PK_ARRAYS = sdk.PK_ARRAYS


@pytest.fixture(scope="module")
def toy():
    z = np.load(FIXTURE)
    ref = {k: z[k] for k in z.files}
    data, _, instances = build_toy()
    mine = CircuitData(cs=ConstraintSystem.from_dict(data.cs.to_dict()),
                       k=data.k, fixed=data.fixed, copies=data.copies,
                       num_instance=data.num_instance)
    vk_dict = json.loads(ref["vk_json"].tobytes())
    ref_pk = from_reference_pk({k: ref[k] for k in PK_ARRAYS}, vk_dict, "cpu")
    params = setup(data.k, device="cpu")
    return dict(ref=ref, data=mine, jdata=data, vk_dict=vk_dict,
                ref_pk=ref_pk, params=params, instances=instances, pk=[])


def _keygen(toy):
    if not toy["pk"]:
        toy["pk"].append(keygen(toy["params"], toy["data"]))
    return toy["pk"][0]


@pytest.mark.parametrize("name", PK_ARRAYS)
def test_toy_keygen_columns_equal_reference(toy, name):
    assert torch.equal(getattr(_keygen(toy), name),
                       getattr(toy["ref_pk"], name))


def test_toy_keygen_vk_equals_reference(toy):
    vk = _keygen(toy).vk
    assert vk.fixed_commitments == toy["ref_pk"].vk.fixed_commitments
    assert (vk.permutation_commitments
            == toy["ref_pk"].vk.permutation_commitments)
    assert vk.transcript_repr() == toy["ref_pk"].vk.transcript_repr()
    assert vk_to_dict(vk) == toy["vk_dict"]


def test_toy_cache_digest_equals_jax(toy):
    assert (toy["data"].cache_digest_bytes()
            == toy["jdata"].cache_digest_bytes())


def test_rsa_cache_digest_equals_committed_sidecar():
    from halo2_zkcert_tpu_torch.cert import extract_public_key, parse_pem
    from halo2_zkcert_tpu_torch.circuits.rsa import RsaCircuit
    with open(os.path.join(ROOT, "testdata", "example_cert_2.pem"), "rb") as f:
        circuit = RsaCircuit(extract_public_key(parse_pem(f.read())), k=17)
    with open(os.path.join(ROOT, "build", "rsa_1.pk.vk")) as f:
        stored = json.load(f)["cache_digest"]
    assert circuit.data.cache_digest_bytes().hex() == stored


def test_fixed_tensor_is_the_reduced_columns(toy):
    data = toy["data"]
    got = data.fixed_tensor("cpu")
    assert got.shape == (data.cs.num_fixed, data.n, 8)
    for i, col in enumerate(data.fixed):
        assert field.to_ints(got[i]) == [int(v) % FR.modulus for v in col]


def test_jax_reads_a_pk_the_port_wrote(toy, tmp_path):
    from halo2_zkcert_tpu.sdk import read_pk as jread_pk
    path = str(tmp_path / "toy.pk")
    sdk.write_pk(toy["ref_pk"], path, cache_digest=b"\x01" * 32)
    jpk = jread_pk(path)
    for name in PK_ARRAYS:
        cols = torch.from_numpy(np.array(getattr(jpk, name)))
        assert torch.equal(field.from_resident(FR, cols),
                           getattr(toy["ref_pk"], name)), name
    assert jpk.vk.transcript_repr() == toy["ref_pk"].vk.transcript_repr()
    with open(path + ".vk") as f:
        assert json.load(f)["cache_digest"] == "01" * 32


def test_port_reads_a_pk_jax_wrote(toy, tmp_path):
    import jax.numpy as jnp
    from halo2_zkcert_tpu.plonk import ProvingKey as JProvingKey
    from halo2_zkcert_tpu.sdk import _vk_from_dict, write_pk as jwrite_pk
    jpk = JProvingKey(vk=_vk_from_dict(toy["vk_dict"]),
                      **{k: jnp.asarray(toy["ref"][k]) for k in PK_ARRAYS})
    path = str(tmp_path / "toy.pk")
    jwrite_pk(jpk, path)
    pk = sdk.read_pk(path, "cpu")
    for name in PK_ARRAYS:
        assert torch.equal(getattr(pk, name), getattr(toy["ref_pk"], name))
    assert vk_to_dict(pk.vk) == toy["vk_dict"]


def test_gen_pk_takes_a_saved_key_of_the_same_circuit(toy, tmp_path,
                                                     monkeypatch):
    """A key saved with this circuit's digest is read, not made again; a
    sidecar without a digest is accepted on the constraint system and given
    the digest; a key of another circuit is made again and overwritten."""
    path = str(tmp_path / "toy.pk")
    data, want = toy["data"], toy["data"].cache_digest_bytes()
    made = []

    def fake_keygen(params, d):
        made.append(d)
        return toy["ref_pk"]

    monkeypatch.setattr(sdk, "keygen", fake_keygen)
    sdk.write_pk(toy["ref_pk"], path, cache_digest=want)
    pk = sdk.gen_pk(toy["params"], data, path)
    assert not made and pk.vk.cs is data.cs
    assert torch.equal(pk.sigma_coeff, toy["ref_pk"].sigma_coeff)

    sdk.write_pk(toy["ref_pk"], path)                  # legacy sidecar
    sdk.gen_pk(toy["params"], data, path)
    with open(path + ".vk") as f:
        assert json.load(f)["cache_digest"] == want.hex()
    assert not made

    sdk.write_pk(toy["ref_pk"], path, cache_digest=b"\0" * 32)
    assert sdk.gen_pk(toy["params"], data, path) is toy["ref_pk"]
    assert made == [data]
    with open(path + ".vk") as f:
        assert json.load(f)["cache_digest"] == want.hex()


def test_legacy_pickle_vk_is_refused(toy):
    legacy = dict(toy["vk_dict"], cs="gASVAAAAAAAAAACMCGJ1aWx0aW5z")
    with pytest.raises(ValueError, match="legacy pickle-format"):
        vk_from_dict(legacy)


def test_gen_snark_and_verify_snark(toy, tmp_path):
    """Prove with the toy key, verify, write: the JAX proof's bytes; the
    snark read back verifies and a wrong instance does not."""
    advice = field.from_resident(FR, torch.from_numpy(toy["ref"]["advice"]))
    path = str(tmp_path / "toy.snark")
    snark = sdk.gen_snark(toy["params"], toy["ref_pk"], advice,
                          toy["instances"], path)
    assert snark.proof == toy["ref"]["proof_poseidon"].tobytes()
    back = sdk.Snark.read(path)
    assert back.proof == snark.proof and back.instances == toy["instances"]
    assert sdk.verify_snark(toy["params"], back, PoseidonTranscript)
    back.instances = [[v + 1 for v in col] for col in back.instances]
    assert not sdk.verify_snark(toy["params"], back)
