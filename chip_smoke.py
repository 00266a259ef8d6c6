"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each printing its own line:
  1. build the hand-written kernels (csrc/*.cu, one nvcc per source, in
     parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path, and time both: the kernel's device time with
     its launches queued behind a spin of the device (`kernel_ms`; "ms" in
     the record) beside its time as Python issues it ("issued_ms"), the
     plain version as issued (once, where it takes seconds).  The
     elementwise kernels, the transform passes, the blocked scans and row
     sums of field elements, the quotient (Montgomery form in and out), the
     mixed-add row scan and the chains of the group law (window tables, the
     Horner step, the fixed-base multiplication) give their plain version's
     words exactly (with digits, in the slots the scan's contract defines);
     the blocked scans and row sums of points add in another order than
     their plain versions, so they are compared after curve.to_affine,
     exactly (canonical affine words are unique);
  3. build the k=17 SRS on the card from the default tau (the path
     "srs_setup") and the fixed-base window tables of both bases
     ("table_build"); commit the committed RSA proving key's 12 fixed and 3
     sigma columns through the variable-base and through the fixed-base MSM:
     both must equal the commitments of build/rsa_1.pk.vk; then a fixed-base
     MSM over 5001 points ("ragged_msm": a pair count that is not whole scan
     rows, the path of the scan of affine points) against the variable-base
     MSM of the same points and scalars;
  4. prove the RSA-2048 k=17 link as the port's bench does, on the fixed
     base (the default: a warm-up proof, then a timed one) and once with the
     variable base forced; each proof must verify, a tampered copy must be
     rejected, and the bytes must equal build/rsa_1.proof;
  5. keygen ("keygen_rsa"): the port's RsaCircuit at k=17 through
     plonk.keygen on the card; its columns (Lagrange and coefficient forms)
     must equal build/rsa_1.pk.npz, its commitments and transcript hash
     build/rsa_1.pk.vk's, and the circuit's cache digest that sidecar's;
  6. the SHA-256 links of the reference's CLI: the k=12 SRS and its window
     tables ("sha256_setup"), then for build/sha256_1 (the TBS of
     example_cert_3.pem) and build/sha256_2 (that of example_cert_2.pem)
     the port's Sha256Circuit, keygen ("sha256_{i}_keygen": the 18 fixed
     and 2 sigma commitments must equal the committed vk's) and a proof
     with the default blinding seed ("sha256_{i}_proof": instances and
     bytes must equal the committed proof, it must verify, and a flipped
     byte must be rejected).  K4 is also held against its plain version on
     the SHA-256 tape (80 slots, extended domain 2^14);
  7. the kernels' launch counts on each driven path, each counted from 0
     just before the path and read just after: each TPU kernel (a record's
     "replaces") must have been launched in one of its forms on one of
     them; the fixed-base proof must launch point_add, point_scan and
     point_row_sum under 100 times together, field_binop under 300 times,
     ntt at most 8 times and none of the chain kernels; each SHA-256
     proof quotient_forest once, and scan_madd and ntt; the RSA keygen
     K1's product, ntt and scan_madd, and none of the chain kernels; the
     variable-base proof no point_double, at most 7 point_horner and 10
     point_add; the table build no point_double and at most 2
     point_windows; the SRS no point_double and no point_add; the ragged
     MSM two point_scan_affine (its one local scan), three point_add (its
     one bucket extraction) and no point_add_mixed.  The [shapes] lines give the shapes the point
     kernels, the transforms and the field scans were called with on each
     path.

Any failure exits non-zero.  The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}.  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at 700 W: HBM at 3.35 TB/s, and 67 T
# float32 operations/s outside the tensor cores.  The data sheet gives no
# 32-bit integer rate, so a 32-bit multiply-add is counted as two operations
# at the float32 rate, as an FMA is.
OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# operations of one canonical 256-bit modular product: an 8 x 8 word
# schoolbook product and an 8 x 8 + 8 word Montgomery reduction, each
# 32 x 32 -> 64-bit product two multiply-adds (low and high word)
OPS_PER_MUL = 2 * 2 * (64 + 72)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the device (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_ms(fn, iters: int, warmup: int = 2) -> tuple:
    """(device ms, issued ms) of one fn(), a kernel's wrapper.

    Issued: the calls as Python issues them (`cuda_ms`).  A wrapper call
    costs the host some tens of microseconds, so for a kernel that runs
    shorter than that the issued time is the host's, not the card's.
    Device: the same loop issued while the device spins
    (`torch.cuda._sleep`) for as long as the host took to issue it, so every
    launch is queued before the first runs and they run back to back."""
    issued = cuda_ms(fn, iters, warmup)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    hz = torch.cuda.get_device_properties(0).clock_rate * 1e3
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((1.5 * host_s + 1e-3) * hz))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, issued


def timed_once(fn) -> tuple:
    """(fn(), its device milliseconds) of one call (CUDA events): for plain
    versions that take seconds, timed on the call whose result is
    compared."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two word tensors, words read as uint32."""
    d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)
    return int(d.abs().max()) if d.numel() else 0


def random_canonical(rng: np.random.Generator, count: int, device,
                     modulus: int) -> torch.Tensor:
    """(count, 8) uniform-ish canonical words, the first rows 0, 1, p - 1."""
    w = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    w[:, 7] %= (modulus >> 224)                    # top word below p's
    edge = [0, 1, modulus - 1]
    for i, v in enumerate(edge[:count]):
        w[i] = [(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _record(name, source, replaces, err, ms, plain_ms, bytes_moved, ops,
            counter=None):
    """`ms`: the pair `kernel_ms` gives.  `counter`: the key of
    ops/kernels.launches that the record's wrapper counts under, where
    several records (shapes, options) share one."""
    ms, issued_ms = ms
    bound_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_o = ops / OPS_PER_S * 1e3
    return {"name": name, "counter": counter or name, "route": "cuda",
            "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "issued_ms": issued_ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "library_ms": None}


def check_field(device, n: int, rng) -> list:
    from halo2_zkcert_tpu_torch.ops import field
    from halo2_zkcert_tpu_torch.ops.field import FQ, FR
    recs = []
    replaces = {"mul": "halo2_zkcert_tpu/ops/pallas_limbs.py:435",
                "add": "halo2_zkcert_tpu/ops/pallas_limbs.py:441",
                "sub": "halo2_zkcert_tpu/ops/pallas_limbs.py:446",
                "mulm": "halo2_zkcert_tpu/ops/pallas_limbs.py:435"}
    for F in (FR, FQ):
        a = random_canonical(rng, n, device, F.modulus)
        b = random_canonical(rng, n, device, F.modulus).flip(0).contiguous()
        for op in ("mul", "add", "sub", "mulm"):
            got = field.binop(F, op, a, b)
            want = field.binop_plain(F, op, a, b)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            ok = torch.equal(got, want)
            log(f"[kernels] field_binop.{op} {F.name} n={n}: "
                f"{'exact' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"field_binop.{op} {F.name} disagrees "
                                     f"with its plain version (err {err})")
            if F is not FR:
                continue
            ms = kernel_ms(lambda: field.binop(F, op, a, b), 20)
            plain_ms = cuda_ms(lambda: field.binop_plain(F, op, a, b), 2, 1)
            recs.append(_record(
                f"field_binop.{op}", "halo2_zkcert_tpu_torch/csrc/field_binop.cu",
                replaces[op], err, ms, plain_ms, 3 * 32 * n,
                OPS_PER_MUL * n if op in ("mul", "mulm") else 0))
    return recs


def _exact(name, kern, plain):
    """Run both, compare word for word; the largest word difference."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    log(f"[kernels] {name}: {'exact' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"(err {max_abs_err(got, want)})")
    return max_abs_err(got, want)


def check_ntt(device, k: int, cols: int, rng) -> list:
    """The transforms of one proof at their shapes: the inverse transform of
    `cols` fresh columns at 2^k, their coset transform onto the extended
    domain 2^(k+2) from 2^k coefficients, Montgomery form out, and the
    inverse coset transform of one Montgomery-form column there.  A
    transform is k / 2 products an element whatever implements it."""
    from halo2_zkcert_tpu_torch.ops import ntt
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    n, ek, g = 1 << k, k + 2, rc.FR_GENERATOR
    a = random_canonical(rng, cols * n, device, FR.modulus).reshape(cols, n, 8)
    h = random_canonical(rng, 1 << ek, device, FR.modulus)[None]
    cases = (
        (f"ntt.inverse[{cols}x{n}]", lambda: ntt.intt(a, k),
         lambda: ntt.intt_plain(a, k), k, cols, n, n),
        (f"ntt.coset.mont[{cols}x{n}->{1 << ek}]",
         lambda: ntt.coset_ntt(a, ek, g, out_mont=True),
         lambda: ntt.coset_ntt_plain(a, ek, g, out_mont=True), ek, cols, n,
         1 << ek),
        (f"ntt.coset_inverse.mont[1x{1 << ek}]",
         lambda: ntt.coset_intt(h, ek, g, in_mont=True),
         lambda: ntt.coset_intt_plain(h, ek, g, in_mont=True), ek, 1, 1 << ek,
         1 << ek),
    )
    recs = []
    for name, kern, plain, kk, B, n_in, n_out in cases:
        err = _exact(name, kern, plain)
        recs.append(_record(
            name, "halo2_zkcert_tpu_torch/csrc/ntt.cu",
            "halo2_zkcert_tpu/ops/pallas_limbs.py:435", err, kernel_ms(kern, 10),
            cuda_ms(plain, 2, 1), 32 * B * (n_in + n_out),
            OPS_PER_MUL * B * n_out * kk // 2, "ntt"))
    return recs


def check_field_scans(device, n: int, rng) -> list:
    """The blocked scans and row sums of field elements at the main path's
    shapes: the grand products of three columns, one row of three columns'
    length (a batched inversion), a suffix sum, the RSA accumulator's affine
    recurrence, and the row sums of 16 columns (the evaluations)."""
    from halo2_zkcert_tpu_torch.ops import frops
    from halo2_zkcert_tpu_torch.ops.field import FR
    src = "halo2_zkcert_tpu_torch/csrc/field_scan.cu"
    mul, add = ("halo2_zkcert_tpu/ops/pallas_limbs.py:435",
                "halo2_zkcert_tpu/ops/pallas_limbs.py:441")
    x = random_canonical(rng, 16 * n, device, FR.modulus).reshape(16, n, 8)
    x[0, :3] = x[0, 3:6]                   # no zero in the product rows
    a3, row, a1, b1 = x[:3], x[:3].reshape(1, 3 * n, 8), x[3:4], x[4:5]
    cases = (
        (f"field_scan.mul[3x{n}]", "field_scan", mul,
         lambda: frops.field_scan(a3, "mul"),
         lambda: frops.field_scan_plain(a3, "mul"), 64 * 3 * n, 3 * (n - 1)),
        (f"field_scan.mul[1x{3 * n}]", "field_scan", mul,
         lambda: frops.field_scan(row, "mul"),
         lambda: frops.field_scan_plain(row, "mul"), 64 * 3 * n, 3 * n - 1),
        (f"field_scan.add.reverse[1x{n}]", "field_scan", add,
         lambda: frops.field_scan(a1, "add", reverse=True),
         lambda: frops.field_scan_plain(a1, "add", reverse=True), 64 * n, 0),
        (f"field_scan.affine[1x{n}]", "field_scan", mul,
         lambda: frops.field_scan(a1, "affine", b=b1),
         lambda: frops.field_scan_plain(a1, "affine", b=b1), 96 * n, n - 1),
        (f"field_row_sum[16x{n}]", "field_row_sum", add,
         lambda: frops.field_row_sum(x),
         lambda: frops.tree_sum_batched_plain(x), 32 * 16 * (n + 1), 0),
    )
    recs = []
    for name, counter, replaces, kern, plain, nbytes, products in cases:
        err = _exact(name, kern, plain)
        recs.append(_record(name, src, replaces, err, kernel_ms(kern, 10),
                            cuda_ms(plain, 2, 1), nbytes,
                            OPS_PER_MUL * products, counter))
    return recs


def sample_affine(device, n: int, rng) -> torch.Tensor:
    """(n, 2, 8) affine points of G1 drawn from 64 host multiples of G."""
    from halo2_zkcert_tpu_torch.ops import curve
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    G = rc.g1_from_affine(rc.G1_GEN)
    aff = curve.points_to_device(
        [rc.g1_to_affine(rc.g1_mul(G, int(s)))
         for s in rng.integers(1, 1 << 62, size=64)], device)
    return aff[torch.from_numpy(rng.integers(0, 64, size=n)).to(device)]


def sample_points(device, n: int, rng) -> torch.Tensor:
    """(n, 3, 8) projective points of G1: 64 host multiples of G, each row
    scaled by its own random Z, with the identity and a few P, -P pairs."""
    from halo2_zkcert_tpu_torch.ops import curve, field
    from halo2_zkcert_tpu_torch.ops.field import FQ
    P = curve.from_affine(sample_affine(device, n, rng))
    z = random_canonical(rng, n, device, FQ.modulus)
    z[:3] = field.one(device, (3,))                # no zero Z from the edges
    P = field.binop_plain(FQ, "mul", P, z[:, None, :])
    P[0] = curve.identity((), device)
    return P.contiguous()


def check_points(device, n: int, rng) -> list:
    from halo2_zkcert_tpu_torch.ops import curve
    P = sample_points(device, n, rng)
    Q = P.roll(1, 0).contiguous()
    Q[1:4] = P[1:4]                               # P + P
    Q[4:8] = curve.neg(P[4:8])                    # P + (-P)
    Q = Q.contiguous()
    recs = []
    cases = (
        ("point_add", lambda: curve.add(P, Q), lambda: curve.add_plain(P, Q),
         "halo2_zkcert_tpu/ops/pallas_limbs.py:372", 12, 9 * 32),
        ("point_double", lambda: curve.double(P), lambda: curve.double_plain(P),
         "halo2_zkcert_tpu/ops/pallas_limbs.py:451", 8, 6 * 32),
    )
    for name, kern, plain, replaces, muls, bytes_per in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ok = torch.equal(got, want)
        log(f"[kernels] {name} n={n}: {'exact' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        recs.append(_record(name, "halo2_zkcert_tpu_torch/csrc/point_ops.cu",
                            replaces, err, kernel_ms(kern, 20),
                            cuda_ms(plain, 2, 1), bytes_per * n,
                            muls * OPS_PER_MUL * n))
    return recs


def check_mixed(device, n: int, rows: int, small_pairs: int, rng) -> list:
    """K5 at n points, and K6 at `rows` rows of 64 points (one full column's
    pairs), every prefix written and, given digits spread as a full column's
    are, the defined slots only; then K6 at the shape a bounded column of
    `small_pairs` pairs gives it.  Table-like affine operands."""
    from halo2_zkcert_tpu_torch.ops import curve, msm_fb
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    G = rc.g1_from_affine(rc.G1_GEN)
    aff = curve.points_to_device(
        [rc.g1_to_affine(rc.g1_mul(G, int(s)))
         for s in rng.integers(1, 1 << 62, size=64)], device)

    def pick(*shape):
        return aff[torch.from_numpy(rng.integers(0, 64, size=shape))
                   .to(device)].contiguous()

    def digits(R, C):
        d = np.sort(rng.integers(0, 1 << 16, size=R * C)).astype(np.int32)
        return torch.from_numpy(d.reshape(R, C)).to(device)

    P, Q = sample_points(device, n, rng), pick(n)
    P[1:4] = curve.from_affine(Q[1:4])            # P + P
    P[4:8] = curve.neg(curve.from_affine(Q[4:8]))  # (-Q) + Q
    C = msm_fb.SCAN_ROW_MAX
    xy = pick(rows, C)
    xy[1] = xy[1, :1]                             # a row that keeps doubling
    d_full = digits(rows, C)
    Cs = msm_fb.scan_row_length(small_pairs)
    xy_small, d_small = pick(small_pairs // Cs, Cs), digits(small_pairs // Cs,
                                                            Cs)
    src = "halo2_zkcert_tpu_torch/csrc/"
    k6 = (src + "scan_madd.cu", "halo2_zkcert_tpu/ops/pallas_limbs.py:533")
    cases = (
        ("point_add_mixed", None, lambda: curve.add_mixed(P, Q),
         lambda: curve.add_mixed_plain(P, Q), src + "point_ops.cu",
         "halo2_zkcert_tpu/ops/pallas_limbs.py:393", n, 8 * 32, None),
        ("scan_madd", None, lambda: msm_fb.scan_madd(xy),
         lambda: msm_fb.scan_madd_plain(xy), *k6, rows * C, 5 * 32, None),
        (f"scan_madd.digits[{rows}x{C}]", "scan_madd",
         lambda: msm_fb.scan_madd(xy, d_full),
         lambda: msm_fb.scan_madd_plain(xy), *k6, rows * C, 5 * 32,
         msm_fb.scan_madd_defined(d_full)),
        (f"scan_madd.digits[{small_pairs // Cs}x{Cs}]", "scan_madd",
         lambda: msm_fb.scan_madd(xy_small, d_small),
         lambda: msm_fb.scan_madd_plain(xy_small), *k6, small_pairs, 5 * 32,
         msm_fb.scan_madd_defined(d_small)),
    )
    recs = []
    for (name, counter, kern, plain, source, replaces, pairs, bytes_per,
         mask) in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if mask is not None:
            got, want = got[mask], want[mask]
        err = max_abs_err(got, want)
        ok = torch.equal(got, want)
        log(f"[kernels] {name} pairs={pairs}: {'exact' if ok else 'MISMATCH'}"
            + ("" if mask is None else
               f" in the {int(mask.sum())} defined slots"))
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        recs.append(_record(name, source, replaces, err, kernel_ms(kern, 10),
                            cuda_ms(plain, 1, 1), bytes_per * pairs,
                            11 * OPS_PER_MUL * pairs, counter))
    return recs


def check_scans(device, B: int, n_buckets: int, n_totals: int, rng) -> list:
    """The blocked point scan and row sum at the main path's shapes: from the
    row's end over (B, n_buckets) buckets, a third of them empty, and their
    row sum (the bucket combine), and forward over (B, n_totals) row totals.
    Compared with the plain versions as affine points."""
    from halo2_zkcert_tpu_torch.ops import curve, scan
    P = sample_points(device, B * n_buckets, rng).reshape(B, n_buckets, 3, 8)
    empty = torch.from_numpy(rng.random((B, n_buckets)) < 1 / 3).to(device)
    P = curve.select(empty, curve.identity((B, n_buckets), device), P)
    P[1] = P[1, :1]                               # a row that keeps doubling
    P = P.contiguous()
    T = P[:, :n_totals].contiguous()
    src = "halo2_zkcert_tpu_torch/csrc/point_scan.cu"
    replaces = "halo2_zkcert_tpu/ops/pallas_limbs.py:372"
    cases = (
        (f"point_scan.reverse[{B}x{n_buckets}]", "point_scan", P,
         lambda: scan.point_scan(P, reverse=True),
         lambda: scan.point_scan_plain(P, reverse=True), 2 * 96),
        (f"point_scan[{B}x{n_totals}]", "point_scan", T,
         lambda: scan.point_scan(T), lambda: scan.point_scan_plain(T),
         2 * 96),
        (f"point_row_sum[{B}x{n_buckets}]", "point_row_sum", P,
         lambda: scan.point_row_sum(P), lambda: scan.point_row_sum_plain(P),
         96),
    )
    recs = []
    for name, counter, X, kern, plain, bytes_per in cases:
        got, want = curve.to_affine(kern()), curve.to_affine(plain())
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ok = torch.equal(got, want)
        log(f"[kernels] {name}: "
            f"{'equal as affine points' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        points = X.shape[0] * X.shape[1]
        recs.append(_record(name, src, replaces, err, kernel_ms(kern, 10),
                            cuda_ms(plain, 1, 1), bytes_per * points,
                            12 * OPS_PER_MUL * (points - X.shape[0]),
                            counter))
    return recs


def check_chains(device, n_points: int, n_scalars: int, rng) -> list:
    """The chains of the group law at the main path's shapes: the window
    tables of a 2^17-point slice of a basis (16 windows of 16 doublings),
    the Horner step of one variable-base MSM call (4 columns, 32 windows of
    8 doublings) and the SRS's fixed-base multiplication (2^18 scalars).
    Each equals its plain version word for word.  Beside the Horner's
    operations bound: its chain's latency floor, its dependent products
    times one product's latency in a one-thread chain (bench.cios_latency_s,
    measured here)."""
    from halo2_zkcert_tpu_torch.bench import cios_latency_s
    from halo2_zkcert_tpu_torch.ops import curve
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.plonk import kzg
    src = "halo2_zkcert_tpu_torch/csrc/point_chain.cu"
    k3 = "halo2_zkcert_tpu/ops/pallas_limbs.py:451"
    k5 = "halo2_zkcert_tpu/ops/pallas_limbs.py:393"
    P = sample_points(device, n_points, rng)
    W = sample_points(device, 4 * 32, rng).reshape(4, 32, 3, 8)
    table = kzg.g1_window_table(device)
    s = random_canonical(rng, n_scalars, device, FR.modulus)
    s[5, :3] = 0                                # zero bytes among the others
    nonzero = int((s.contiguous().view(torch.uint8) != 0).sum())
    horner_products = 31 * 8 * 8 + 32 * 12
    cases = (
        (f"point_windows[{n_points}x16x16]", "point_windows", k3,
         lambda: curve.windows(P, 16, 16),
         lambda: curve.windows_plain(P, 16, 16), 96 * 17 * n_points,
         15 * 16 * 8 * n_points),
        ("point_horner[4x32x8]", "point_horner", k3,
         lambda: curve.horner(W, 8), lambda: curve.horner_plain(W, 8),
         96 * (4 * 32 + 4), 4 * horner_products),
        (f"point_fixed_mul[{n_scalars}]", "point_fixed_mul", k5,
         lambda: curve.fixed_mul(s, table),
         lambda: curve.fixed_mul_plain(s, table),
         table.numel() * 4 + (32 + 96) * n_scalars, 11 * nonzero),
    )
    recs = []
    for name, counter, replaces, kern, plain, nbytes, products in cases:
        got = kern()
        want, plain_ms = timed_once(plain)
        ok = torch.equal(got, want)
        log(f"[kernels] {name}: {'exact' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(err {max_abs_err(got, want)})")
        recs.append(_record(name, src, replaces, max_abs_err(got, want),
                            kernel_ms(kern, 5), plain_ms, nbytes,
                            OPS_PER_MUL * products, counter))
    latency = cios_latency_s(device)
    recs[1]["latency_floor_ms"] = horner_products * latency * 1e3
    log(f"[kernels] point_horner: {horner_products} dependent products a "
        f"column at {latency * 1e9:.1f} ns each in a one-thread chain: floor "
        f"{recs[1]['latency_floor_ms']:.4f} ms")
    return recs


def check_affine_scans(device, shapes, rng) -> list:
    """The scan of affine points at the main path's shapes: the bucket scan
    of one variable-base MSM call (128 rows of 2^17 sorted points) and the
    ragged fixed-base MSM's local scan (2 rows of 80 016 pairs), a few
    (0, 0) among the points.  Compared with the plain version as affine
    points; the plain version runs 4 rows at a time (its Hillis-Steele
    sweep over 2^24 points at once would not fit the card), timed once."""
    from halo2_zkcert_tpu_torch.ops import curve, scan
    recs = []
    for B, n in shapes:
        xy = sample_affine(device, B * n, rng).reshape(B, n, 2, 8)
        xy[:, 7] = 0                           # the identity in every row
        got = curve.to_affine(scan.point_scan_affine(xy))
        plain = (lambda: torch.cat([scan.point_scan_affine_plain(xy[r:r + 4])
                                    for r in range(0, B, 4)]))
        want, plain_ms = timed_once(plain)
        want = curve.to_affine(want)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        name = f"point_scan_affine[{B}x{n}]"
        log(f"[kernels] {name}: "
            f"{'equal as affine points' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        recs.append(_record(
            name, "halo2_zkcert_tpu_torch/csrc/point_scan.cu",
            "halo2_zkcert_tpu/ops/pallas_limbs.py:393", max_abs_err(got, want),
            kernel_ms(lambda: scan.point_scan_affine(xy), 3), plain_ms,
            (64 + 96) * B * n, 11 * OPS_PER_MUL * B * (n - 1),
            "point_scan_affine"))
        del xy, got, want
    return recs


def check_quotient(device, vk_path: str, rng, name="quotient_forest",
                   path=None) -> dict:
    """K4 on the tape of the key at `vk_path` over random Montgomery-form
    leaves of its extended domain, against its plain version, exactly.
    `path`: the driven path whose launches the record reports."""
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.plonk import quotient
    from halo2_zkcert_tpu_torch.sdk import read_vk
    vk = read_vk(vk_path)
    dom = vk.domain(device)
    tape = quotient.compile_tape(vk.cs, dom.n, dom.extended_n)
    L = len(quotient.leaf_layout(vk.cs))
    ext_n = dom.extended_n
    leaves = random_canonical(rng, L * ext_n, device,
                              FR.modulus).reshape(L, ext_n, 8)
    chal = random_canonical(rng, tape.num_challenges, device, FR.modulus)
    consts = tape.const_table(chal)       # Montgomery form, as the leaves are
    got = quotient.quotient_forest(leaves, consts, tape)
    want = quotient.quotient_forest_plain(leaves, consts, tape)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ok = torch.equal(got, want)
    nmul = int((tape.ins[:, 0] == quotient.MUL).sum())
    log(f"[kernels] {name} ext_n={ext_n} leaves={L} "
        f"tape={len(tape.ins)} muls={nmul} slots={tape.num_slots}: "
        f"{'exact' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    rec = _record(
        name, "halo2_zkcert_tpu_torch/csrc/quotient_forest.cu",
        "halo2_zkcert_tpu/plonk/quotient_pallas.py:315", err,
        kernel_ms(lambda: quotient.quotient_forest(leaves, consts, tape), 10),
        cuda_ms(lambda: quotient.quotient_forest_plain(leaves, consts, tape),
                1, 1),
        (L + 1) * ext_n * 32 + consts.numel() * 4,
        nmul * OPS_PER_MUL * ext_n, "quotient_forest")
    if path is not None:
        rec["path"] = path
    return rec


# ---------------------------------------------------------------------------
# phases 3 and 4: SRS + key commitments, then the proof
# ---------------------------------------------------------------------------

class forced_msm:
    """Force the commitment MSM for the block: "1" fixed base, "0" variable
    base (the H2T_FB_MSM knob of plonk/kzg.py)."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.saved = os.environ.get("H2T_FB_MSM")
        os.environ["H2T_FB_MSM"] = self.mode

    def __exit__(self, *exc):
        if self.saved is None:
            del os.environ["H2T_FB_MSM"]
        else:
            os.environ["H2T_FB_MSM"] = self.saved


def check_srs(device, params_dir: str):
    from halo2_zkcert_tpu_torch.bench import load_rsa_link
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import kzg
    kzg.g1_window_table.cache_clear()        # the SRS path builds its table
    kernels.reset_launches()
    with recorded_shapes() as rec:
        t0 = time.perf_counter()
        params = kzg.setup(17, device=device)
        torch.cuda.synchronize()
        t_srs = time.perf_counter() - t0
    launches = {"srs_setup": dict(kernels.launches)}
    os.makedirs(params_dir, exist_ok=True)
    params.write(os.path.join(params_dir, "kzg_bn254_17.srs"))
    log(f"[srs] k=17 built on the card in {t_srs:.3f} s")
    log(f"[shapes] srs_setup: {json.dumps(rec.shapes, sort_keys=True)}")
    kernels.reset_launches()
    with recorded_shapes() as rec:
        t0 = time.perf_counter()
        for lagrange in (True, False):
            params.fixed_base(lagrange)
        torch.cuda.synchronize()
        t_tables = time.perf_counter() - t0
    launches["table_build"] = dict(kernels.launches)
    tab = params.fixed_base(True).table_flat
    log(f"[tables] fixed-base window tables of both bases built in "
        f"{t_tables:.3f} s ({tab.shape[0]} points, "
        f"{tab.numel() * 4 / 1e6:.1f} MB a basis)")
    log(f"[shapes] table_build: {json.dumps(rec.shapes, sort_keys=True)}")
    circuit, pk, sig, digest = load_rsa_link(device)
    for label, mode in (("variable base", "0"), ("fixed base", "1")):
        with forced_msm(mode):
            t0 = time.perf_counter()
            fixed = kzg.commit_many_lagrange(params, pk.fixed_lagrange)
            sigma = kzg.commit_many_lagrange(params, pk.sigma_lagrange)
            t_commit = time.perf_counter() - t0
        ok = (fixed == pk.vk.fixed_commitments
              and sigma == pk.vk.permutation_commitments)
        log(f"[commit] {label}: {len(fixed)} fixed + {len(sigma)} sigma "
            f"commitments in {t_commit:.3f} s: "
            f"{'equal to' if ok else 'DIFFERENT FROM'} build/rsa_1.pk.vk")
        if not ok:
            raise AssertionError(f"{label}: key commitments differ from the "
                                 f"reference vk")
    launches["ragged_msm"] = check_ragged(device, params, 5001)
    return params, circuit, pk, sig, digest, launches


def check_ragged(device, params, n: int) -> dict:
    """Fixed-base MSM over the first n points of g, n chosen so that the
    pair count is not whole scan rows: equal to the variable-base MSM."""
    from halo2_zkcert_tpu_torch.ops import curve, kernels, msm, msm_fb
    from halo2_zkcert_tpu_torch.ops.field import FR
    base = params.g[:n].contiguous()
    rng = np.random.default_rng(n)
    cols = random_canonical(rng, 2 * n, device, FR.modulus).reshape(2, n, 8)
    fb = msm_fb.FixedBaseMsm(base)
    assert fb.nwin * n % msm_fb.SCAN_ROW_MAX, "pair count must be ragged"
    kernels.reset_launches()
    with recorded_shapes() as rec:
        got = curve.to_affine(fb.msm_many(cols))
    launches = dict(kernels.launches)
    want = curve.to_affine(msm.msm_many(base, cols))
    ok = torch.equal(got, want)
    log(f"[ragged] fixed-base MSM over {n} points ({fb.nwin * n} pairs, "
        f"{launches.get('point_scan_affine', 0)} point_scan_affine "
        f"launches): "
        f"{'equal to' if ok else 'DIFFERENT FROM'} the variable-base MSM")
    log(f"[shapes] ragged_msm: {json.dumps(rec.shapes, sort_keys=True)}")
    if not ok:
        raise AssertionError("ragged fixed-base MSM differs")
    return launches


class recorded_shapes:
    """Count, for the block, the shapes that the wrappers of the point
    kernels (`curve.add`, `curve.windows`, `curve.horner`,
    `curve.fixed_mul`, `msm_fb.scan_madd`, `scan.point_scan`,
    `scan.point_scan_affine`, `scan.point_row_sum`), of the transforms
    (`ntt.ntt`, ...) and of the field scans (`frops.field_scan`,
    `frops.field_row_sum`) are called with: `.shapes` maps "name(shape)" to
    calls."""

    def __enter__(self):
        from collections import Counter
        from halo2_zkcert_tpu_torch.ops import curve, frops, msm_fb, ntt, scan
        self.shapes = Counter()
        # module, function, trailing axes that are not part of the shape
        self.saved = [(curve, "add", 2), (curve, "windows", 2),
                      (curve, "horner", 2), (curve, "fixed_mul", 1),
                      (msm_fb, "scan_madd", 2), (scan, "point_scan", 2),
                      (scan, "point_scan_affine", 2),
                      (scan, "point_row_sum", 2),
                      (ntt, "ntt", 1), (ntt, "intt", 1), (ntt, "coset_ntt", 1),
                      (ntt, "coset_intt", 1), (frops, "field_scan", 1),
                      (frops, "field_row_sum", 1)]
        self.saved = [(m, n, t, getattr(m, n)) for m, n, t in self.saved]
        for mod, name, tail, fn in self.saved:
            def wrapped(x, *a, _fn=fn, _name=name, _tail=tail, **k):
                lead = "x".join(str(d) for d in x.shape[:-_tail])
                self.shapes[f"{_name}({lead})"] += 1
                return _fn(x, *a, **k)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, _, fn in self.saved:
            setattr(mod, name, fn)


def prove(device, label, params, circuit, pk, sig, digest, warmup) -> dict:
    """Prove the link on the commitment path in force, verify, reject a
    tampered copy, compare with build/rsa_1.proof; the launch counts of the
    last proof."""
    from halo2_zkcert_tpu_torch.bench import prove_rsa
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import prover, verify_proof
    from halo2_zkcert_tpu_torch.sdk import Snark
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    ref = Snark.read(os.path.join(REPO, "build", "rsa_1.proof"))
    runs = (["warm-up"] if warmup else []) + ["timed"]
    for what in runs:
        kernels.reset_launches()
        with recorded_shapes() as rec:
            proof, instances, dt = prove_rsa(params, circuit, pk, sig, digest,
                                             device)
        launches = dict(kernels.launches)
        same = ref.proof == proof and ref.instances == instances
        log(f"[prove] {label}: {what} proof {dt:.3f} s, {len(proof)} bytes, "
            f"{'equal to' if same else 'DIFFERENT FROM'} build/rsa_1.proof, "
            f"stages {json.dumps(prover.LAST_STAGE_TIMES)}")
        if not same:
            raise AssertionError(f"{label}: proof bytes or instances differ "
                                 f"from build/rsa_1.proof")
    t0 = time.perf_counter()
    ok = verify_proof(params, pk.vk, instances, proof, PoseidonTranscript)
    t_ver = time.perf_counter() - t0
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    rejected = not verify_proof(params, pk.vk, instances, bytes(bad),
                                PoseidonTranscript)
    log(f"[verify] {label}: accepts the proof: {ok} ({t_ver:.3f} s); "
        f"rejects a flipped byte: {rejected}")
    if not (ok and rejected):
        raise AssertionError(f"{label}: verifier check failed")
    log(f"[shapes] {label}: {json.dumps(rec.shapes, sort_keys=True)}")
    return launches


# ---------------------------------------------------------------------------
# phases 5 and 6: keygen, and the SHA-256 links
# ---------------------------------------------------------------------------

def check_keygen_rsa(device, params, circuit, card: str) -> dict:
    """keygen of the port's RsaCircuit at k=17 on the card (the window
    tables are already built): its 12 fixed and 3 sigma columns, Lagrange and
    coefficient forms, equal build/rsa_1.pk.npz, its 15 commitments and
    transcript_repr equal build/rsa_1.pk.vk's, and the circuit's
    cache_digest_bytes() that sidecar's cache_digest."""
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import keygen
    from halo2_zkcert_tpu_torch.sdk import PK_ARRAYS, read_pk
    path = os.path.join(REPO, "build", "rsa_1.pk")
    ref = read_pk(path, device, cs=circuit.cs)
    with open(path + ".vk") as f:
        stored = json.load(f)["cache_digest"]
    kernels.reset_launches()
    with recorded_shapes() as rec:
        t0 = time.perf_counter()
        pk = keygen(params, circuit.data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(kernels.launches)
    checks = {k: torch.equal(getattr(pk, k), getattr(ref, k))
              for k in PK_ARRAYS}
    checks["commitments"] = (
        pk.vk.fixed_commitments == ref.vk.fixed_commitments
        and pk.vk.permutation_commitments == ref.vk.permutation_commitments)
    checks["transcript_repr"] = (pk.vk.transcript_repr()
                                 == ref.vk.transcript_repr())
    checks["cache_digest"] = circuit.data.cache_digest_bytes().hex() == stored
    log(f"[keygen] rsa k=17: {len(pk.vk.fixed_commitments)} fixed + "
        f"{len(pk.vk.permutation_commitments)} sigma columns in {dt:.3f} s "
        f"as issued ({card}); equal to build/rsa_1.pk: "
        f"{json.dumps(checks, sort_keys=True)}")
    log(f"[shapes] keygen_rsa: {json.dumps(rec.shapes, sort_keys=True)}")
    if not all(checks.values()):
        raise AssertionError(f"RSA keygen differs from build/rsa_1.pk: "
                             f"{checks}")
    return launches


def sha256_link(device, params, index: int, pem: str, card: str) -> dict:
    """One SHA-256 link of the reference's CLI: the TBS of `pem` through
    the port's Sha256Circuit at k=12, keygen on the card (its 18 fixed and
    2 sigma commitments equal build/sha256_{index}.pk.vk's), the witness and
    a proof with the default blinding seed, whose instances and bytes equal
    build/sha256_{index}.proof; the proof verifies and a flipped byte is
    rejected.  The launch counts of the keygen and of the proof."""
    from halo2_zkcert_tpu_torch.cert import extract_tbs_and_sig, parse_pem
    from halo2_zkcert_tpu_torch.circuits.sha256 import Sha256Circuit
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import (create_proof, keygen, prover,
                                              verify_proof)
    from halo2_zkcert_tpu_torch.sdk import Snark, read_vk
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    name = f"sha256_{index}"
    with open(os.path.join(REPO, "testdata", pem), "rb") as f:
        tbs, _ = extract_tbs_and_sig(parse_pem(f.read()))
    circuit = Sha256Circuit.build(len(tbs))
    assert circuit.data.k == params.k == 12, "SHA-256 links are at k=12"
    ref_vk = read_vk(os.path.join(REPO, "build", f"{name}.pk.vk"))
    ref = Snark.read(os.path.join(REPO, "build", f"{name}.proof"))
    launches = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    pk = keygen(params, circuit.data)
    torch.cuda.synchronize()
    t_key = time.perf_counter() - t0
    launches[f"{name}_keygen"] = dict(kernels.launches)
    same_key = (pk.vk.fixed_commitments == ref_vk.fixed_commitments
                and pk.vk.permutation_commitments
                == ref_vk.permutation_commitments
                and pk.vk.transcript_repr() == ref_vk.transcript_repr())
    log(f"[keygen] {name}: {len(tbs)}-byte TBS of {pem}, k=12, "
        f"{len(pk.vk.fixed_commitments)} fixed + "
        f"{len(pk.vk.permutation_commitments)} sigma columns in {t_key:.3f} "
        f"s as issued ({card}): "
        f"{'equal to' if same_key else 'DIFFERENT FROM'} build/{name}.pk.vk")
    if not same_key:
        raise AssertionError(f"{name}: key commitments differ from the "
                             f"reference vk")
    kernels.reset_launches()
    with recorded_shapes() as rec:
        t0 = time.perf_counter()
        advice, instances = circuit.witness(tbs, device)
        proof = create_proof(params, pk, advice, instances,
                             PoseidonTranscript())
        dt = time.perf_counter() - t0
    launches[f"{name}_proof"] = dict(kernels.launches)
    same = ref.proof == proof and ref.instances == instances
    log(f"[prove] {name}: proof {dt:.3f} s as issued ({card}), "
        f"{len(proof)} bytes, "
        f"{'equal to' if same else 'DIFFERENT FROM'} build/{name}.proof, "
        f"stages {json.dumps(prover.LAST_STAGE_TIMES)}")
    if not same:
        raise AssertionError(f"{name}: proof bytes or instances differ from "
                             f"build/{name}.proof")
    ok = verify_proof(params, pk.vk, instances, proof, PoseidonTranscript)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    try:
        rejected = not verify_proof(params, pk.vk, instances, bytes(bad),
                                    PoseidonTranscript)
    except (AssertionError, ValueError):
        rejected = True                           # an undecodable point
    log(f"[verify] {name}: accepts the proof: {ok}; rejects a flipped "
        f"byte: {rejected}")
    if not (ok and rejected):
        raise AssertionError(f"{name}: verifier check failed")
    log(f"[shapes] {name}_proof: {json.dumps(rec.shapes, sort_keys=True)}")
    return launches


def check_launches(launches: dict) -> None:
    """The launch counts each driven path must keep (module docstring)."""
    fb = launches["fixed_base_proof"]
    point_launches = sum(fb.get(k, 0) for k in ("point_add", "point_scan",
                                                "point_row_sum"))
    if point_launches >= 100 or not fb.get("scan_madd"):
        raise AssertionError(f"fixed-base proof: {point_launches} launches of "
                             f"the point kernels, scan_madd "
                             f"{fb.get('scan_madd', 0)}")
    binop_launches = sum(v for k, v in fb.items()
                         if k.startswith("field_binop."))
    log(f"[launches] fixed_base_proof: field_binop {binop_launches} in all, "
        f"ntt {fb.get('ntt', 0)}")
    if binop_launches >= 300 or not 0 < fb.get("ntt", 0) <= 8:
        raise AssertionError(f"fixed-base proof: {binop_launches} launches of "
                             f"field_binop, {fb.get('ntt', 0)} of ntt")
    chains = ("point_double", "point_add_mixed", "point_windows",
              "point_horner", "point_fixed_mul", "point_scan_affine")
    vb, tb = launches["variable_base_proof"], launches["table_build"]
    srs, rg = launches["srs_setup"], launches["ragged_msm"]
    kg = launches["keygen_rsa"]
    sha = [launches[f"sha256_{i}_proof"] for i in (1, 2)]
    rules = (
        ("each SHA-256 proof: one quotient_forest, scan_madd, ntt",
         all(p.get("quotient_forest", 0) == 1 and p.get("scan_madd", 0)
             and p.get("ntt", 0) for p in sha)),
        ("RSA keygen: field_binop.mul (sigma), ntt (coefficients), scan_madd "
         "(commitments), no chain kernel",
         kg.get("field_binop.mul", 0) and kg.get("ntt", 0)
         and kg.get("scan_madd", 0) and not any(kg.get(k, 0)
                                                for k in chains)),
        ("fixed-base proof launches no chain kernel",
         not any(fb.get(k, 0) for k in chains)),
        ("variable-base proof: no point_double, 1-7 point_horner, at most 10 "
         "point_add", not vb.get("point_double", 0)
         and 0 < vb.get("point_horner", 0) <= 7
         and vb.get("point_add", 0) <= 10),
        ("table build: no point_double, 1-2 point_windows",
         not tb.get("point_double", 0)
         and 0 < tb.get("point_windows", 0) <= 2),
        ("SRS setup: no point_double, no point_add, point_fixed_mul",
         not srs.get("point_double", 0) and not srs.get("point_add", 0)
         and srs.get("point_fixed_mul", 0) > 0),
        ("ragged MSM: 2 point_scan_affine, 3 point_add, no point_add_mixed",
         rg.get("point_scan_affine", 0) == 2 and rg.get("point_add", 0) == 3
         and not rg.get("point_add_mixed", 0)),
    )
    for what, ok in rules:
        log(f"[launches] {what}: {'yes' if ok else 'NO'}")
    broken = [what for what, ok in rules if not ok]
    if broken:
        raise AssertionError(f"launch counts: {broken}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from halo2_zkcert_tpu_torch.ops import kernels
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    build_s = kernels.build_all(verbose=True)
    card = card_line()
    log(f"[build] kernels built in {build_s:.3f} s")
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    recs = check_field(device, 1 << 19, rng)
    recs += check_ntt(device, 17, 8, rng)
    recs += check_field_scans(device, 1 << 17, rng)
    recs += check_points(device, 1 << 17, rng)
    # a bounded column of the proof: one window of every row and the other
    # 15 of the blinding rows, padded to whole 64-point rows
    recs += check_mixed(device, 1 << 17, 1 << 15, 131264, rng)
    recs += check_scans(device, 4, (1 << 16) - 1, 1 << 15, rng)
    recs += check_chains(device, 1 << 17, 1 << 18, rng)
    # the variable-base bucket scan of 4 columns, and the ragged MSM's
    recs += check_affine_scans(device, ((128, 1 << 17), (2, 16 * 5001)), rng)
    recs.append(check_quotient(
        device, os.path.join(REPO, "build", "rsa_1.pk.vk"), rng))
    recs.append(check_quotient(
        device, os.path.join(REPO, "build", "sha256_1.pk.vk"), rng,
        "quotient_forest[sha256 tape]", "sha256_1_proof"))
    for r in recs:
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms ({r['issued_ms']:.4f} "
            f"as issued from Python, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']})")

    params_dir = os.environ.get("PARAMS_DIR",
                                os.path.join(REPO, "params"))
    params, circuit, pk, sig, digest, launches = check_srs(device, params_dir)
    link = (params, circuit, pk, sig, digest)
    from halo2_zkcert_tpu_torch.plonk import kzg
    assert kzg.commit_path(params) == "fixed_base", "default commit path"
    launches["fixed_base_proof"] = prove(device, "fixed base", *link,
                                         warmup=True)
    with forced_msm("0"):
        launches["variable_base_proof"] = prove(device, "variable base",
                                                *link, warmup=False)
    launches["keygen_rsa"] = check_keygen_rsa(device, params, circuit, card)
    del params, circuit, pk, link
    torch.cuda.empty_cache()

    kernels.reset_launches()
    t0 = time.perf_counter()
    params12 = kzg.setup(12, device=device)
    params12.fixed_base(lagrange=True)
    params12.fixed_base(lagrange=False)
    torch.cuda.synchronize()
    launches["sha256_setup"] = dict(kernels.launches)
    log(f"[srs] k=12 and both window tables built on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    for index, pem in ((1, "example_cert_3.pem"), (2, "example_cert_2.pem")):
        launches.update(sha256_link(device, params12, index, pem, card))

    paths = ("fixed_base_proof", "variable_base_proof", "ragged_msm",
             "table_build", "srs_setup", "keygen_rsa", "sha256_setup",
             "sha256_1_keygen", "sha256_1_proof", "sha256_2_keygen",
             "sha256_2_proof")
    for path in paths:
        log(f"[launches] {path}: "
            f"{json.dumps(launches[path], sort_keys=True)}")
    for r in recs:
        r["launches_by_path"] = {p: launches[p].get(r["counter"], 0)
                                 for p in paths}
        r["launches_path"] = r.pop("path", None) or next(
            (p for p in paths if r["launches_by_path"][p] > 0), None)
        r["launches"] = r["launches_by_path"].get(r["launches_path"], 0)
    missing = sorted({r["replaces"] for r in recs}
                     - {r["replaces"] for r in recs if r["launches"] > 0})
    if missing:
        raise AssertionError(f"TPU kernels launched in no form on any driven "
                             f"path: {missing}")
    check_launches(launches)

    print(card, flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
