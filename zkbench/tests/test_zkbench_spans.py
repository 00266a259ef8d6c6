"""The readers of the program's spans and counters (zkbench/spans.py and the
metrics that use it) on a synthetic run whose idle gaps and spans are
known: two traced proofs, each a witness tape before `prove` and, inside
it, two stages with a witness phase, blinding draws and a commitment with
a gather (and one that ends where it begins); the proof that the
profiler's start stalled lies before the stretch.  The idle pieces add up
to the stretch's idle, those charged to proofs plus those between them;
each reader is silent without a trace or without the program's recorder
(a program that has none)."""
from types import SimpleNamespace

import pytest

from zkbench import spans as spans_mod
from zkbench.harness import Run, load_cell, reader
from zkbench.loop import Proof
from zkbench.trace import Trace


def _span(name, proof, start, end, parent=None, device_ms=None):
    return SimpleNamespace(name=name, proof=proof, start=start, end=end,
                           parent=parent, device_ms=device_ms,
                           seconds=end - start)


def _proof_spans(pid, t0):
    """One proof's spans, its record starting at t0."""
    wit = _span("witness", pid, t0, t0 + 0.3)
    prove = _span("prove", pid, t0 + 0.3, t0 + 1.9)
    commits = _span("phase commits", pid, t0 + 0.31, t0 + 0.8, prove)
    phase = _span("witness", pid, t0 + 0.32, t0 + 0.4, commits)
    blind = _span("blinding", pid, t0 + 0.45, t0 + 0.5, commits)
    commit = _span("commit", pid, t0 + 0.5, t0 + 0.7, commits)
    gather = _span("msm_gather", pid, t0 + 0.55, t0 + 0.56, commit, 2.0)
    empty = _span("msm_gather", pid, t0 + 0.62, t0 + 0.62, commit, 0.0)
    gp = _span("grand products+random", pid, t0 + 0.8, t0 + 1.9, prove)
    words = _span("blinding", pid, t0 + 1.0, t0 + 1.2, gp)
    return [wit, prove, commits, phase, blind, commit, gather, empty, gp,
            words]


IDLE = [(100.1, 100.2),        # the witness tape
        (100.46, 100.48),      # a blinding draw
        (100.6, 100.65),       # the commitment, outside its gather
        (101.1, 101.3),        # half a blinding draw, half its stage
        (101.95, 102.05)]      # between proofs, then the next tape
IDLE += [(s + 2, min(e + 2, 104.0)) for s, e in IDLE[:4]] + [(103.95, 104.0)]
COUNTERS = {"transcript_s": 0.01, "pairs": 1000, "buckets": 256,
            "columns": 1}


@pytest.fixture
def run(monkeypatch):
    stalled = _span("blinding", -1, 95.0, 96.0)
    recs = SimpleNamespace(
        spans=[stalled] + _proof_spans(0, 100.0) + _proof_spans(1, 102.0),
        proofs={-1: {"transcript_s": 9.0}, 0: dict(COUNTERS),
                1: dict(COUNTERS)})
    monkeypatch.setattr(spans_mod, "records", lambda: recs)
    cell, config, counts = load_cell("rsa2048_k17.solo")
    tr = Trace(100.0, 104.0, 4.0 - sum(e - s for s, e in IDLE),
               {"k_scan_madd(x)": 0.0008, "k_point_add(y)": 0.0002,
                "void at::native::vectorized_gather_kernel<16>": 0.5},
               {"k_scan_madd(x)": 2}, IDLE)
    proofs = [Proof(0, 90.0, 100.0, None, {}, b"p"),
              Proof(0, 100.0, 102.0, 0.3, {}, b"p"),
              Proof(1, 102.0, 104.0, 0.3, {}, b"p")]
    return Run(cell, config, counts, 99.0, 105.0, proofs, 12.5, 1, {}, tr)


def test_idle_is_cut_at_the_spans_and_adds_up(run):
    split = spans_mod.idle_split(run)
    want = {"witness": 0.1 + 0.05 + 0.1, "blinding": 0.02 + 0.1 + 0.02 + 0.1,
            "commit": 0.05 + 0.05, "grand products+random": 0.1 + 0.1,
            "between proofs": 0.05 + 0.05}
    assert split.keys() == want.keys()
    for k, v in want.items():
        assert split[k] == pytest.approx(v), k
    idle_s = run.trace.window_s - run.trace.busy_s
    assert sum(split.values()) == pytest.approx(idle_s)


def test_the_readers_on_known_spans(run):
    n = 2
    assert reader("idle_ms.blinding")(run) == pytest.approx(1e3 * 0.24 / n)
    assert reader("idle_ms.glue")(run) == pytest.approx(1e3 * 0.3 / n)
    # the tape and the phase call
    assert reader("witness_ms.program")(run) == pytest.approx(
        1e3 * 2 * (0.3 + 0.08) / n)
    assert reader("transcript_ms")(run) == pytest.approx(1e3 * 0.02 / n)
    assert reader("device_ms.msm_gather")(run) == pytest.approx(2.0)
    pk = run.counts["peaks"]
    products = 11 * 1000 + 2 * 12 * 255
    bound = products * pk["ops_per_product"] / pk["ops_per_s"]
    assert reader("msm_roofline")(run) == pytest.approx(
        100 * bound / (0.001 / n))


NEW = ("witness_ms.program", "transcript_ms", "msm_roofline",
       "device_ms.msm_gather", "idle_ms.blinding", "idle_ms.glue")


@pytest.mark.parametrize("name", NEW)
def test_silent_without_a_trace_or_a_recorder(run, monkeypatch, name):
    read = reader(name)
    assert read(Run(run.cell, run.config, run.counts, 99.0, 105.0,
                    run.proofs, 12.5, 1, {}, None)) is None
    monkeypatch.setattr(spans_mod, "records", lambda: None)
    assert read(run) is None


def test_records_of_a_program_without_the_recorder(monkeypatch):
    """A parent commit's program has no utils/trace.py."""
    import builtins
    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "halo2_zkcert_tpu_torch.utils" and "trace" in (
                fromlist or ()):
            raise ImportError("no recorder")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert spans_mod.records() is None
