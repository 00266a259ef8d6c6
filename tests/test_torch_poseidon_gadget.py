"""The port's in-circuit Poseidon (circuits/poseidon_gadget.py) against the
host permutation and sponge and against the JAX package's gadget, as
tests/test_poseidon_gadget.py holds the JAX one: the same cell values, the
same circuit at k=13, and a satisfied MockProver."""
import numpy as np
import torch

from halo2_zkcert_tpu.builder import GateBuilder as JGateBuilder
from halo2_zkcert_tpu.circuits import poseidon_gadget as jgadget
from halo2_zkcert_tpu_torch.builder import GateBuilder
from halo2_zkcert_tpu_torch.circuits.poseidon_gadget import (
    PoseidonSpongeGadget, permute_cells)
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.plonk import run_mock
from halo2_zkcert_tpu_torch.transcript.poseidon import (PoseidonSponge,
                                                        permute, permute_plain)
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

torch.set_num_threads(2)


def test_permutation_matches_host():
    for state in ([3, 7, 11], [0, 0, 0], [rc.FR - 1, 1, 2]):
        gb = GateBuilder(lookup_bits=7)
        out = permute_cells(gb, [gb.witness(v) for v in state])
        want = permute_plain(state)
        assert [c.value for c in out] == want == permute(state)
        jgb = JGateBuilder(lookup_bits=7)
        jout = jgadget.permute_cells(jgb, [jgb.witness(v) for v in state])
        assert [c.value for c in jout] == want
        assert gb.values == jgb.values
        assert len(gb.copy_a) == len(jgb.copies)


def _sponge(builder_cls, gadget_cls):
    gb = builder_cls(lookup_bits=7)
    sp = gadget_cls(gb)
    sp.update([gb.witness(123), gb.witness(456)])
    c1 = sp.squeeze()
    sp.update([gb.witness(789)])
    c2 = sp.squeeze()
    gb.expose_public(c1)
    gb.expose_public(c2)
    return gb, (c1.value, c2.value)


def test_sponge_matches_host_and_constraints_hold():
    gb, got = _sponge(GateBuilder, PoseidonSpongeGadget)
    host = PoseidonSponge()
    host.update([123, 456])
    h1 = host.squeeze()
    host.update([789])
    h2 = host.squeeze()
    assert got == (h1, h2)

    data, advice, instances = gb.finalize(13, device="cpu")
    assert instances[0] == [h1, h2]
    assert run_mock(data, advice, instances) == []

    jgb, jgot = _sponge(JGateBuilder, jgadget.PoseidonSpongeGadget)
    assert jgot == got
    jdata, jadvice, jinstances = jgb.finalize(13)
    assert data.cs.to_dict() == jdata.cs.to_dict()
    assert np.array_equal(data.fixed, jdata.fixed)
    assert list(data.copies) == jdata.copies
    assert instances == jinstances
    assert torch.equal(advice, field.from_resident(
        field.FR, torch.from_numpy(np.array(jadvice, dtype=np.int32))))

    bad = [[h1, (h2 + 1) % rc.FR]]
    fails = run_mock(data, advice, bad, raise_on_failure=False)
    assert fails and fails[-1].startswith("copy constraint violated")
