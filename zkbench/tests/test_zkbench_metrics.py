"""The metric arithmetic on synthetic records: the rate over the window,
the p95 over every proof, proofs cut off by the close, the union of device
intervals, the per-proof readings over the proofs wholly inside the traced
stretch, and the readers' silence where they find nothing to read."""
import pytest

from zkbench import stats
from zkbench.breakdown import breakdown, label
from zkbench.loop import Proof
from zkbench.harness import Run, load_cell, reader
from zkbench.trace import Trace


def _run(proofs, t_open=100.0, t_close=110.0, trace=None, launches=None):
    cell, config, counts = load_cell("rsa2048_k17.solo")
    return Run(cell, config, counts, t_open, t_close, proofs, 12.5,
               3_000_000_000, launches or {}, trace)


def _proof(start, end, witness=None, stages=None, ok=True):
    return Proof(0, start, end, witness, stages or {},
                 b"p" if ok else None, None if ok else "error")


def test_rate_counts_only_proofs_returned_inside_the_window():
    proofs = [_proof(100 + i, 101 + i) for i in range(10)]
    proofs.append(_proof(109.5, 111.0))          # returns after the close
    run = _run(proofs)
    assert reader("proofs_per_s")(run) == pytest.approx(10 / 10.0)


def test_p95_over_all_proofs_with_the_late_one():
    lat = [0.1 * (i + 1) for i in range(20)]
    proofs = [_proof(100.0, 100.0 + x) for i, x in enumerate(lat)]
    proofs.append(_proof(109.9, 112.9))          # late, latency 3 s
    want = stats.quantile(lat + [3.0], 0.95)
    assert reader("proof_p95_s")(_run(proofs)) == pytest.approx(want)
    assert want > stats.quantile(lat, 0.95)


def test_quantile_interpolates_between_order_statistics():
    assert stats.quantile([1, 2, 3, 4, 5], 0.95) == pytest.approx(4.8)
    assert stats.quantile([7], 0.95) == 7


def test_failed_proofs_are_not_completed_nor_in_the_tail():
    proofs = [_proof(100, 101), _proof(101, 109, ok=False)]
    run = _run(proofs)
    assert reader("proofs_per_s")(run) == pytest.approx(0.1)
    assert reader("proof_p95_s")(run) == pytest.approx(1.0)


def test_union_of_intervals():
    a = [(0, 2), (5, 6)]
    b = [(1, 3), (5.5, 7), (10, 11)]
    assert stats.union_length(a + b) == pytest.approx(3 + 2 + 1)
    assert stats.gaps(a + b, 0, 12) == [(3, 5), (7, 10), (11, 12)]


def test_idle_share_and_the_msm_time_a_proof():
    tr = Trace(lo=100.0, hi=104.0, busy_s=1.0,
               device_s={"k_scan_madd(x)": 0.2, "k_point_scan(z)": 0.1,
                         "k_ntt_pass(y)": 0.1,
                         "void at::native::vectorized_gather_kernel<16>": 0.2},
               launches={"k_scan_madd(x)": 4, "k_ntt_pass(y)": 8},
               idle=[(101.0, 102.0)])
    # two proofs wholly inside the stretch; the one before it (stalled by
    # the profiler's start) and the one after it are not counted
    proofs = [_proof(90.0, 100.0), _proof(100.0, 101.0),
              _proof(101.0, 104.0), _proof(104.0, 105.0)]
    run = _run(proofs, trace=tr, launches={"ntt": 32})
    assert [p.start for p in run.traced] == [100.0, 101.0]
    assert reader("device_idle_share")(run) == pytest.approx(75.0)
    # the MSM's own kernels only, not the gathers
    assert reader("device_ms.msm")(run) == pytest.approx(1e3 * 0.3 / 2)
    # two proofs' transforms took 0.1 s
    c = run.counts
    products = sum(cols * (1 << k) * k / 2 for cols, k in c["transforms"])
    bound = products * c["peaks"]["ops_per_product"] / c["peaks"]["ops_per_s"]
    assert reader("ntt_roofline")(run) == pytest.approx(100 * bound / 0.05)


@pytest.mark.parametrize("launches", [1, 4])
def test_quotient_roofline_reads_a_proof_at_a_time(launches):
    # three traced proofs, each running K4 in one launch over the extended
    # domain or in four, one a coset: the same work over the same time
    name = "k_quotient_forest<48>(x)"
    tr = Trace(100.0, 103.0, 1.0, {name: 0.06}, {name: 3 * launches}, [])
    run = _run([_proof(100 + i, 101 + i) for i in range(3)], trace=tr)
    c = run.counts
    bound = (c["quotient_products_per_row"] * c["extended_rows"]
             * c["peaks"]["ops_per_product"] / c["peaks"]["ops_per_s"])
    assert reader("quotient_forest_roofline")(run) == pytest.approx(
        100 * bound / 0.02)


def test_readers_stay_silent_without_a_trace():
    run = _run([_proof(100, 101)])
    for name in ("device_idle_share", "device_ms.msm", "ntt_roofline",
                 "quotient_forest_roofline", "witness_ms",
                 "stage_ms.quotient"):
        assert reader(name)(run) is None


def test_stage_and_witness_means_over_the_traced_proofs():
    stalled = _proof(90, 100, 9.0, {"phase commits": 9.0,
                                     "quotient+commit": 9.0})
    proofs = [stalled,
              _proof(100, 101, 0.02, {"phase commits": 0.03,
                                      "quotient+commit": 0.01}),
              _proof(101, 102, 0.04, {"phase commits": 0.05,
                                      "quotient+commit": 0.03}),
              _proof(102, 103, 0.03, {"phase commits": 0.04,
                                      "quotient+commit": 0.05})]
    tr = Trace(100.0, 103.0, 1.0, {"k": 1.0}, {"k": 1}, [])
    run = _run(proofs, trace=tr, launches={"ntt": 16, "field_binop.mul": 84})
    # the stalled proof lies before the stretch and does not weigh in
    assert reader("witness_ms")(run) == pytest.approx(30.0)
    assert reader("stage_ms.phase_commits")(run) == pytest.approx(40.0)
    assert reader("stage_ms.quotient")(run) == pytest.approx(30.0)
    assert reader("launches_per_proof")(run) == pytest.approx(25.0)


def test_idle_gaps_are_named_by_what_the_prover_did():
    p = _proof(100.0, 101.0, 0.2, {"phase commits": 0.3,
                                      "quotient+commit": 0.4})
    run = _run([p], trace=Trace(99.0, 102.0, 1.0, {"k": 1.0}, {"k": 1},
                                [(100.05, 100.15), (100.6, 100.7),
                                 (101.2, 101.4)]))
    assert label(run, 100.1) == "witness"
    assert label(run, 100.65) == "quotient+commit"
    assert label(run, 101.3) == "between proofs"
    names = [n for n, _ in breakdown(run)["idle_gaps"]]
    assert names[0].startswith("between proofs (1 gaps")
