"""The span recorder (halo2_zkcert_tpu_torch/utils/trace.py) and what the
prover records in it.

On the CPU: spans nest, each with its parent and self time; proof ids
advance when `create_proof` returns, so a span opened before a proof (the
RSA witness tape) takes that proof's id; the buffer is bounded; nothing is
recorded where recording is off.  The toy circuit's proof (the key,
witness and instances of tests/data/toy_reference.npz) under a CPU-only
torch.profiler gives one `prove` span and its six stages with its id, each
stage's seconds those of LAST_STAGE_TIMES; its commitments are replaced by
a fixed point here, since the structure and not the bytes is tested
(tests/test_torch_selfcheck.py holds the bytes and the printed lines).
The fixed-base MSM counts its columns, pairs and buckets from shapes and
keeps its result; the transcript's counter grows with each call.

The `gpu` test runs on a card (python -m pytest --noconftest
tests/test_torch_trace.py -m gpu): the recorder is on inside a profile of
CUDA activity only, and a gather's device interval resolves to a positive
time.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from halo2_zkcert_tpu_torch.ops import field, msm_fb
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.plonk import (create_proof, from_reference_pk,
                                          kzg, prover, setup)
from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
from halo2_zkcert_tpu_torch.utils import refcrypto as rc
from halo2_zkcert_tpu_torch.utils import trace

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PK_ARRAYS = ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff")
STAGES = ["phase commits", "lookup permute+commit", "grand products+random",
          "quotient+commit", "evals", "multiopen"]


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder, off unless a test turns it on."""
    for knob in ("H2T_PROFILE", "H2T_PROFILE2"):
        monkeypatch.delenv(knob, raising=False)
    trace.reset()
    yield trace
    trace.reset()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parent_self_time_and_counters(rec, monkeypatch):
    monkeypatch.setenv("H2T_PROFILE", "1")
    with rec.span("a"):
        with rec.span("b"):
            rec.count(pairs=3)
            rec.count(pairs=4, buckets=1)
        with rec.span("c"):
            with rec.span("d"):
                pass
    got = rec.records()
    a, b, c, d = got.spans
    assert [s.name for s in got.spans] == ["a", "b", "c", "d"]
    assert a.parent is None and b.parent is a and c.parent is a
    assert d.parent is c
    assert a.self_s == pytest.approx(a.seconds - b.seconds - c.seconds)
    assert c.self_s == pytest.approx(c.seconds - d.seconds)
    assert d.self_s == d.seconds > 0
    assert a.start < b.start < b.end < c.start < d.start < d.end < c.end \
        < a.end
    assert b.counters == {"pairs": 7, "buckets": 1} and a.counters is None
    assert got.proofs == {0: {"pairs": 7, "buckets": 1}}


def test_a_span_before_a_proof_takes_its_id(rec, monkeypatch):
    """The id advances when the proof ends, recording or not."""
    monkeypatch.setenv("H2T_PROFILE", "1")
    with rec.span("witness"):
        pass
    with rec.proving():
        with rec.span("blinding"):
            rec.count(n=1)
    monkeypatch.delenv("H2T_PROFILE")
    with rec.proving():                       # off: nothing, id 1 used up
        rec.count(n=5)
    monkeypatch.setenv("H2T_PROFILE", "1")
    with pytest.raises(RuntimeError):
        with rec.proving():
            raise RuntimeError("the proof fails")
    with rec.span("witness"):
        rec.count(n=2)
    got = _by_name(rec.records().spans)
    assert [s.proof for s in got["witness"]] == [0, 3]
    assert [s.proof for s in got["prove"]] == [0, 2]
    assert got["blinding"][0].parent is got["prove"][0]
    assert got["witness"][0].parent is None
    assert rec.records().proofs == {0: {"n": 1}, 3: {"n": 2}}


def test_the_buffer_is_bounded(rec, monkeypatch):
    monkeypatch.setenv("H2T_PROFILE", "1")
    for i in range(rec.MAX_SPANS + 5):
        with rec.span(f"s{i}"):
            pass
    spans = rec.records().spans
    assert len(spans) == rec.MAX_SPANS
    assert spans[0].name == "s5" and spans[-1].name == f"s{rec.MAX_SPANS + 4}"
    for _ in range(rec.MAX_PROOFS + 3):
        with rec.proving():
            rec.count(n=1)
    ids = sorted(rec.records().proofs)
    assert len(ids) == rec.MAX_PROOFS and ids[-1] == rec.MAX_PROOFS + 2


def test_nothing_is_recorded_when_off(rec):
    assert not rec.on()
    with rec.span("a", ("H2T_PROFILE", "prove", "a")) as s:
        rec.count(pairs=1)
    assert s is None
    tick = rec.Ticks("prove", "H2T_PROFILE")
    assert tick("a") >= 0
    t = PoseidonTranscript()
    t.common_scalar(5)
    t.squeeze_challenge()
    got = rec.records()
    assert got.spans == [] and got.proofs == {}


def test_ticks_share_one_reading_and_print_under_their_knob(rec, monkeypatch,
                                                            capsys):
    monkeypatch.setenv("H2T_PROFILE2", "1")
    tick = rec.Ticks("quot", "H2T_PROFILE2")
    first = tick("lag2coeff x3")
    second = tick("pointwise")
    tick_off = rec.Ticks("keygen", "H2T_PROFILE")
    tick_off("fb tables")
    a, b, c = rec.records().spans
    assert (a.name, b.name, c.name) == ("lag2coeff x3", "pointwise",
                                        "fb tables")
    assert a.end == b.start and a.seconds == first and b.seconds == second
    assert capsys.readouterr().out.splitlines() == [
        f"    [quot] lag2coeff x3: {first:.3f}s",
        f"    [quot] pointwise: {second:.3f}s"]


def test_inside_a_cpu_profile_the_recorder_is_on(rec):
    with profile(activities=[ProfilerActivity.CPU]):
        assert rec.on()
        with rec.span("a"):
            pass
    assert not rec.on()
    assert [s.name for s in rec.records().spans] == ["a"]


@pytest.fixture(scope="module")
def toy():
    z = np.load(os.path.join(DATA, "toy_reference.npz"))
    pk = from_reference_pk({k: z[k] for k in PK_ARRAYS},
                           json.loads(z["vk_json"].tobytes()), "cpu")
    return dict(pk=pk, params=setup(pk.vk.k, device="cpu"),
                advice=field.from_resident(FR, torch.from_numpy(z["advice"])),
                instances=json.loads(z["instances_json"].tobytes()))


def test_toy_proof_under_the_profiler(rec, toy, monkeypatch):
    monkeypatch.setattr(kzg, "_commit",
                        lambda base, cols: [rc.G1_GEN] * cols.shape[0])
    with profile(activities=[ProfilerActivity.CPU]):
        create_proof(toy["params"], toy["pk"], toy["advice"],
                     toy["instances"], PoseidonTranscript())
    got = rec.records()
    by = _by_name(got.spans)
    (prove,) = by["prove"]
    stages = [s for s in got.spans if s.parent is prove]
    assert [s.name for s in stages] == STAGES
    assert all(s.proof == prove.proof == 0 for s in got.spans)
    assert {s.name: s.seconds for s in stages} == prover.LAST_STAGE_TIMES
    assert all(a.end == b.start for a, b in zip(stages, stages[1:]))
    assert prove.start <= stages[0].start and stages[-1].end <= prove.end
    (wit,) = by["witness"]                   # the toy has one phase
    assert wit.parent is stages[0]
    # the advice, the permuted lookup columns, the Zs' rows and the random
    # polynomial's words
    assert {s.parent.name for s in by["blinding"]} == {
        "phase commits", "lookup permute+commit", "grand products+random"}
    assert len(by["blinding"]) == 3 + 2 + 2
    assert {s.parent.name for s in by["commit"]} == set(STAGES) - {"evals"}
    assert [s.name for s in got.spans if s.parent is not None
            and s.parent.name == "quotient+commit"] == [
        "lag2coeff x9", "coeff2ext x9", "pointwise", "h coset_intt",
        "commit"]
    assert got.proofs[0]["transcript_s"] > 0


def _columns(seed, m, n):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(m * n)]
    return field.from_ints(FR, vals, "cpu").reshape(m, n, 8)


@pytest.fixture(scope="module")
def fb16():
    return msm_fb.FixedBaseMsm(setup(4, device="cpu").g_lagrange, wbits=8)


@pytest.mark.parametrize("path", ["full", "bounded", "streamed"])
def test_msm_counts_pairs_and_buckets_and_keeps_its_result(rec, fb16,
                                                           monkeypatch, path):
    """16 points, 8-bit windows: 32 windows; the bounded layout takes 2
    windows a row and all 32 on the 4 blinding rows."""
    cols = _columns(7, 3, 16)
    if path == "bounded":
        cols[:, :12, 1:] = 0                          # below 2^16
        cols[:, :12, 0] &= 0xFFFF
        run = lambda: fb16.msm_many_bounded(cols, 16, 12)  # noqa: E731
        pairs = 2 * 16 + 30 * 4
    else:
        if path == "streamed":
            monkeypatch.setattr(fb16, "STREAM_PAIRS", 1, raising=False)
            monkeypatch.setattr(msm_fb, "CHUNK", 256)
        run = lambda: fb16.msm_many(cols)  # noqa: E731
        pairs = 32 * 16
    want = run()
    assert rec.records().proofs == {}
    monkeypatch.setenv("H2T_PROFILE", "1")
    with rec.span("commit") as commit:
        got = run()
    assert torch.equal(got, want)
    counts = {"columns": 3, "pairs": 3 * pairs, "buckets": 3 * 256}
    assert commit.counters == counts
    assert rec.records().proofs == {0: counts}
    gathers = [s for s in rec.records().spans if s.name == "msm_gather"]
    assert gathers and all(s.parent is commit and s.device_ms is None
                           for s in gathers)
    assert len(gathers) == (2 * 3 if path == "streamed" else 1)


def test_transcript_counter_grows_with_each_call(rec, monkeypatch):
    t = PoseidonTranscript()
    t.common_scalar(1)
    assert rec.records().proofs == {}
    monkeypatch.setenv("H2T_PROFILE", "1")
    seen = [0.0]

    def grew():
        now = rec.records().proofs[0]["transcript_s"]
        assert now > seen[0]
        seen[0] = now

    for call in (lambda: t.common_scalar(3), t.squeeze_challenge,
                 lambda: t.write_scalar(7), lambda: t.write_point(rc.G1_GEN),
                 t.finalize):
        call()
        grew()
    monkeypatch.delenv("H2T_PROFILE")
    t.write_scalar(9)
    assert rec.records().proofs[0]["transcript_s"] == seen[0]


@pytest.mark.gpu
def test_cuda_only_profile_turns_the_recorder_on_and_times_a_gather(rec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    table = torch.arange(1 << 24, dtype=torch.int32, device=dev)
    rows = torch.randint(0, 1 << 24, (1 << 24,), device=dev)
    with profile(activities=[ProfilerActivity.CUDA]):
        assert rec.on()
        with rec.span("msm_gather", device=dev):
            out = table[rows]
    assert torch.equal(out, rows.to(torch.int32))
    (s,) = rec.records().spans
    assert s.device_ms is not None and s.device_ms > 0
