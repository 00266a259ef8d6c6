"""The composed circuit's phase-1 replay
(halo2_zkcert_tpu_torch/circuits/composed.py `_Replay`): the A lanes and
builder columns at any tau, from the build pass's record, equal a full pass
of the program at that tau (`record_phase1`) word for word, the phase-0
columns never change, and the replay is a span with its counters.  Small
programs at k=17 (the tape's 2^16-row range table sets the floor) on the
CPU's plain arithmetic, in seconds.  The proof-bytes test runs on the card
(`gpu`); on a machine with one:

    python -m pytest --noconftest tests/test_torch_composed_replay.py -q -m gpu
"""
import random

import pytest
import torch

from halo2_zkcert_tpu_torch.circuits.composed import ComposedCircuit
from halo2_zkcert_tpu_torch.circuits.ecc_gadget import EccGadget
from halo2_zkcert_tpu_torch.plonk import run_mock
from halo2_zkcert_tpu_torch.plonk.mock import mock_challenges
from halo2_zkcert_tpu_torch.utils import refcrypto as rc
from halo2_zkcert_tpu_torch.utils import trace

torch.set_num_threads(2)

A_VAL = 0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF1234567890ABCD
B_VAL = 0xFEDCBA0987654321FEDCBA0987654321FEDCBA0987654321FEDCBA09876543
K = 17


def lincomb_chain(gb, tape):
    """Mulmods, lazy sums and differences fed to further relations: builder
    gates two and more levels above the regions' evaluations."""
    a, b = tape.witness_elem(A_VAL), tape.witness_elem(B_VAL)
    z = tape.mulmod(a, b)
    s = tape.add(tape.sub(a, b), tape.scale(z, 3))
    w = tape.mulmod(s, tape.add_int(a, 7))
    tape.assert_eq_mod(tape.sub(w, z), tape.reduce(tape.sub(w, z)))
    gb.expose_public(gb.mul(gb.witness(5), gb.constant(9)))


def ec_msm(gb, tape):
    """Point additions, a doubling and a two-point MSM (the aggregation's
    in-circuit MSM at 16-bit scalars), over two lanes."""
    g = rc.g1_from_affine(rc.G1_GEN)
    p1 = rc.g1_to_affine(rc.g1_mul(g, 7))
    p2 = rc.g1_to_affine(rc.g1_mul(g, 11))
    ecc = EccGadget(tape)
    a, b = ecc.witness_point(p1), ecc.witness_point(p2)
    ecc.double(ecc.add(a, b))
    ecc.msm([a, b], [gb.witness(0xBEEF), gb.witness(0x1234)], nbits=16)


PROGRAMS = {"lincomb_chain": (lincomb_chain, 1, 1), "ec_msm": (ec_msm, 2, 2)}


@pytest.fixture(scope="module", params=sorted(PROGRAMS))
def circ(request):
    program, lanes, na = PROGRAMS[request.param]
    return ComposedCircuit(program, k=K, lanes=lanes, na=na)


def _taus(seed: int, count: int = 3) -> list:
    rng = random.Random(seed)
    return [rng.randrange(rc.FR) for _ in range(count)]


@pytest.mark.parametrize("which", range(3))
def test_replay_equals_full_pass(circ, which):
    """At each of three seeded taus, every phase-1 column the replay gives
    equals the full pass's word for word, and the replay re-evaluated
    builder gates as well as the regions' evaluations."""
    tau = _taus(2024)[which]
    cols = circ.phase1_columns(tau)
    full = circ.record_phase1(tau)
    assert sorted(cols) == sorted(full) == sorted(circ.a_indices
                                                  + circ.b_indices)
    for i in full:
        assert torch.equal(cols[i], full[i]), i
    rep = circ.prepare_replay("cpu")
    assert rep.levels and rep.cells.numel() > rep.eval_cells.numel()


def test_phase0_never_changes(circ):
    """The phase-0 columns are the build pass's V lanes and stay so across
    replays at other taus, and a replay leaves its record as it was."""
    fn, _ = circ.witness("cpu")
    first = {i: v.clone() for i, v in fn(0, {}).items()}
    rep = circ.prepare_replay("cpu")
    words0, advice0 = rep.words0.clone(), rep.advice0.clone()
    for tau in _taus(7):
        fn(1, {0: tau})
    assert sorted(first) == sorted(circ.v_indices)
    for j, i in enumerate(circ.v_indices):
        assert torch.equal(fn(0, {})[i], first[i])
        want = torch.zeros_like(first[i])
        want[:, 0] = torch.from_numpy(circ._v_vals0[j]).to(torch.int32)
        assert torch.equal(first[i], want)
    assert torch.equal(rep.words0, words0) and torch.equal(rep.advice0,
                                                           advice0)


def test_columns_are_kept_for_their_tau(circ):
    """A second call at the same tau returns the kept columns; another tau
    replays without running the program (no pass is recorded)."""
    tau, other = _taus(11, 2)
    passes = len(circ.pass_seconds)
    first = circ.phase1_columns(tau)
    assert circ.phase1_columns(tau) is first
    second = circ.phase1_columns(other)
    assert len(circ.pass_seconds) == passes
    assert any(not torch.equal(first[i], second[i]) for i in first)


def test_replay_spans_and_counters(monkeypatch):
    """Each replay is a `replay` span with the tape rows and builder cells
    it re-evaluated as counters, inside the caller's span; the columns'
    hand-over is a `witness_h2d` span."""
    monkeypatch.setenv("H2T_PROFILE", "1")
    c = ComposedCircuit(lincomb_chain, k=K)
    fn, _ = c.witness("cpu")
    trace.reset()
    with trace.span("witness"):
        fn(1, {0: 12345})
    spans = {s.name: s for s in trace.records().spans}
    rep = c.prepare_replay("cpu")
    replay = spans["replay"]
    assert replay.parent is spans["witness"]
    assert replay.counters == {"replay_rows": rep.rows,
                               "replay_cells": rep.cells.numel()}
    assert spans["witness_h2d"].parent is spans["witness"]
    assert trace.records().proofs[0]["replay_rows"] == rep.rows
    trace.reset()


def test_selfcheck_reports_the_replay(monkeypatch, capsys):
    monkeypatch.setenv("H2T_SELFCHECK", "1")
    c = ComposedCircuit(lincomb_chain, k=K)
    c.phase1_columns(777)
    assert "[selfcheck] phase-1 replay: OK" in capsys.readouterr().out


def test_full_pass_catches_a_value_outside_the_record():
    """A program that witnesses a value computed from a region's evaluation
    (not through a gate) is outside what the replay records: the full pass
    tells it apart."""
    def program(gb, tape):
        a = tape.witness_elem(A_VAL)
        tape.mulmod(a, a)
        gb.witness(rc.finv(a.eval_cell.value, rc.FR))

    c = ComposedCircuit(program, k=K)
    assert not c.replay_matches(4242)


def test_mock_satisfied_through_the_replay():
    """The MockProver, at its own challenge, is satisfied by the replayed
    columns."""
    c = ComposedCircuit(lincomb_chain, k=K)
    fn, inst = c.witness("cpu")
    assert mock_challenges(c.cs)[0] != 0
    assert run_mock(c.data, fn, inst, raise_on_failure=False) == []


def test_expression_memo_is_freed_with_the_call():
    """`expression.evaluate`'s memo (the prover's device tensors) is freed
    when the call returns, not when the cyclic collector next runs, so the
    memory a proof holds does not depend on the collector's schedule."""
    import gc
    import weakref
    from halo2_zkcert_tpu_torch.plonk import expression as ex
    leaves = []

    def fixed(i, r):
        t = torch.full((4, 8), i, dtype=torch.int32)
        leaves.append(weakref.ref(t))
        return t

    e = ex.Fixed(0) * ex.Fixed(1) + ex.Fixed(0)
    was = gc.isenabled()
    gc.disable()
    try:
        out = ex.evaluate(e, constant=None, fixed=fixed, advice=None,
                          instance=None, challenge=None,
                          add=lambda a, b: a + b, mul=lambda a, b: a * b,
                          scale=None)
        assert int(out[0, 0]) == 0 and len(leaves) == 2
        del out
        assert not any(w() is not None for w in leaves)
    finally:
        if was:
            gc.enable()


@pytest.mark.gpu
def test_proof_bytes_equal_the_full_pass():
    """On the card: a proof whose phase 1 is replayed and one whose phase 1
    is the full pass, at the same blinding seed, are the same bytes; both
    verify."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from halo2_zkcert_tpu_torch.plonk import create_proof, keygen, verify_proof
    from halo2_zkcert_tpu_torch.plonk.kzg import setup
    from halo2_zkcert_tpu_torch.plonk.assignment import BlindingRng
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    dev = torch.device("cuda", 0)
    c = ComposedCircuit(ec_msm, k=K, lanes=2, na=2)
    params = setup(K, device=dev)
    pk = keygen(params, c.data)
    fn, inst = c.witness(dev)

    def full(phase, ch):
        if phase == 0:
            return fn(0, ch)
        return {i: w.to(dev) for i, w in c.record_phase1(ch[0]).items()}

    proofs = [create_proof(params, pk, w, inst, PoseidonTranscript(),
                           BlindingRng(b"replay")) for w in (fn, full)]
    assert proofs[0] == proofs[1]
    assert verify_proof(params, pk.vk, inst, proofs[0], PoseidonTranscript)
