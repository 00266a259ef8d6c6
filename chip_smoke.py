"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each printing its own line:
  1. build the hand-written kernels (csrc/*.cu, one nvcc per source, in
     parallel) and the transcripts' host library (csrc/hostmath.cpp, g++),
     and print the card's name and power limit; hold the host library
     against its plain versions (the [native] lines: the Poseidon
     permutation on 1000 seeded states, Keccak-256 at lengths 0, 1, 135,
     136, 137 and 1000) and print the host's microseconds a call of each;
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
  7. the vertical-gate builder's sample circuit (tests/test_builder.py,
     with a lookup) at k=8 ("builder_sample"): keygen and a proof with the
     default blinding seed equal tests/data/builder_reference.npz (the
     JAX package's), the proof verifies and a wrong instance is rejected,
     MockProver on CUDA tensors is satisfied and reports a corrupted advice
     cell as the JAX package does ("builder_sample_mock");
  8. the gate-level SHA-256 of b"abc" at k=15 ("sha256_gate_short", the
     constraint system of the CLI's size): the k=15 SRS and tables, keygen
     and a proof equal tests/data/sha256_gate_reference.npz; K4 held
     against its plain version on that constraint system's tape at k=19
     (503 instructions, 37 slots, extended domain 2^20);
  9. the gate-level SHA-256 of the reference CLI ("sha256_gate_cli"): the
     970-byte TBS of example_cert_3.pem at k=19, the SRS and both window
     tables, the circuit, keygen, MockProver on the card (satisfied), a
     proof that verifies and rejects a flipped byte, instances equal to
     hashlib's digest; each step's wall seconds and the proof's stages;
     then the other kernels at the shapes that this path gave them and no
     earlier record holds, each against its plain version: the transforms
     of its 29 fresh columns from 2^19 onto 2^20 and back, its 15 grand
     products and the batched inversion's 15 x 2^19 row, the row sums of
     16 columns at 2^19, the mixed-add row scan over a commitment batch's
     2^25 pairs with their digits, and the k=19 SRS's 2^20 fixed-base
     products (the window tables are built in 2^17-point slices, phase 2's
     shape); the proof again under H2T_SELFCHECK=1 and =4 (phase 15's
     checks: the same bytes, every verdict OK, K4's 48-slot
     rematerialized tape held to the exact oracle);
 12. (run before phase 10, whose inner snarks it writes) the reference
     CLI's chain through `cli.main` on the card ("cli"), its build and
     params directories in a temporary directory under build/, the
     certificates from testdata/: gen-params --k 17; gen-rsa-keys and
     prove-rsa for both RSA links (example_cert_3 by example_cert_2, and
     example_cert_2 by the root example_cert_1, a 4096-bit key); gen-zkevm-
     sha256-keys and prove-zkevm-sha256 for example_cert_3 and
     example_cert_2 (k=12); gen-unoptimized-sha256-keys and
     prove-unoptimized-sha256 for example_cert_3 at k=19.  Each snark file
     of the first four must equal
     build/{rsa_1,rsa_2,sha256_1,sha256_2}.proof in its proof bytes,
     instances and vk, and each key's vk build/<stem>.pk.vk in its
     commitments, constraint system and cache digest (where that sidecar
     has one); the k=19 one must verify, be rejected with a byte flipped
     and carry hashlib's digest; each prove subcommand must read the key
     file its keys subcommand wrote and make no key; each subcommand's
     wall seconds, each key file's bytes, write and read seconds and the
     host's resident memory before and at its peak;
 10. the X.509 aggregation of the reference CLI's `gen-x509-agg-proof`
     ("x509_agg"): X509VerifierAggregationCircuit over the four inner
     snarks phase 12 wrote at k=20, lanes 8, na 8, nl 1, fixed-vk mode.  First the
     circuit as the JAX package records it (`keep_identity_terms=True`):
     its record pass, the k=20 SRS and both window tables, `sdk.gen_pk`
     (the vk must equal build/x509_agg.pk.vk field for field: k, instance
     rows, accumulator indices, constraint system, 58 fixed and 27
     permutation commitments, cache digest), both phases' advice columns
     and the instances held to tests/data/aggregation_reference.npz (the
     JAX package's digests at its tau, the MockProver's challenge), its
     accumulator must fail the deferred pairing (ROADMAP fault C2) though
     MockProver on the card is satisfied (on that pass).  Then the port's
     circuit through the CLI's subcommands on `cli.main`: gen-x509-agg-keys
     (the k=20 SRS set up and written, keygen: the constraint system of
     build/x509_agg.pk.vk; the key file's bytes, write seconds and host
     memory), gen-x509-agg-proof (the key read from that file and not made
     again, its read seconds and host memory; MockProver on the card,
     satisfied, on the circuit it recorded, through a wrapper of
     `cli.aggregation_step`; the snark with the default blinding seed, its
     stages and blake2b; `verify_aggregated` true, and false for a flipped
     byte), each subcommand's seconds and peak device memory.  Then the kernels at the shapes that
     path gave them and no earlier record holds: the transforms of its 67
     fresh columns from 2^20 onto 2^22 and back, its 23 grand products and
     the batched inversion's 23 x 2^20 row, the row sums of 16 columns at
     2^20, K6 at the proof's launch shapes with digits (65 536 rows x 32,
     262 192 x 64), the k=20 SRS's 2^21 fixed-base products, and K4 on its
     tape over 2^22 rows (157 leaves; the plain version on the first 2^18
     rows).  Before those kernels, right after `verify_aggregated`, the
     CLI's `gen-x509-agg-evm-proof` on `cli.main` ("x509_agg_evm", the key
     read from the same file): the
     Solidity verifier (its length and blake2b), the Keccak proof (its
     witness a fresh phase-1 pass at the Keccak transcript's tau; stages,
     bytes, blake2b, peak device memory), `evm_verify`; then
     `verify_aggregated` with the Keccak transcript must be true, the EVM
     must accept (its gas, the deployed runtime's size, the interpreter's
     seconds), `execute_ir` must agree, and the EVM must reject a flipped
     byte, a changed instance and a proof cut short by 32 bytes.  The IR,
     bytecode and Solidity of the toy vk and of
     build/{rsa_1,rsa_2,sha256_1,sha256_2,x509_agg}.pk.vk must equal the
     JAX package's (their digests in tests/data/evm_reference.json), and
     the toy fixture's Keccak proof must pass the port's EVM with the JAX
     EVM's gas.  After the kernels at the aggregation's shapes, the toy
     with an accumulator ("acc_toy", tests/data/make_evm_reference.py: the
     toy circuit at k=6, its 8 instance rows the limbs of an accumulator
     pair) keyed and proved with `sdk.gen_evm_proof` for a good pair
     (P, tau P) and a bad one (P, (tau + 1) P): `verify_proof` accepts
     both, the EVM and `execute_ir` only the good one;
 13. (run after phase 4) the four-step transform on the int8 tensor cores
     ("ntt_mxu"): the four-step `intt` over (8, 2^17) and `coset_ntt`
     (8, 2^17 -> 2^19, Montgomery form out) must equal the radix-2
     kernel's, timed beside it and the transform's own bound (ntt.cu's,
     the same function); each base DFT launch they make (csrc/ntt_mxu.cu)
     is held against its plain version over every column and timed beside
     the plain version and torch._int_mm on the same s8 product (the
     library yardstick; the port never calls it), its bound counting the
     band of nonzero digits of the constant matrix; then the RSA k=17 proof with
     H2T_NTT_MXU=1 on the fixed base (a warm-up and a timed proof) must
     verify, reject a flipped byte and equal build/rsa_1.proof;
 14. (after phase 13) the sharded prover ("sharded"): four `gloo` ranks
     spawned on cuda:0 (NCCL refuses two ranks on one card; the mesh stages
     its collectives through CPU tensors), the kernels built before: on
     each rank the sharded MSM over the k=17 SRS's 2^17 points and the
     sharded transform and inverse of (8, 2^17) equal to the single-device
     calls, and the RSA k=17 proof under `prover_mesh` equal to
     build/rsa_1.proof, with its seconds, launches, transforms split or
     replicated, and the bytes and seconds of its collectives; then a
     one-rank `nccl` group through the same sharded calls, and, with two
     cards or more, `nccl` ranks a card each (up to 4) through them and a
     warm-up and 3 proofs each, beside as many proofs on one card alone
     on the variable base (`check_card_a_rank`);
 15. (after phase 13) the prover's debugging knobs ("knobs"): the RSA
     k=17 proof on the fixed base under H2T_SELFCHECK=1, 2, 3, 4 and
     H2T_EVAL_MODE=coeff must equal build/rsa_1.proof with every verdict
     OK (plonk/prover.py LAST_SELFCHECK); then with a fault patched into
     plonk/prover.py for the run, a Z value before its commitment must be
     reported at level 1 (the identity at x: MISMATCH) and at level 3 (the
     recurrence: VIOLATED), a row of K4's output at level 4 (the window:
     MISMATCH);
 11. the kernels' launch counts on each driven path, each counted from 0
     just before the path and read just after: each TPU kernel (a record's
     "replaces") must have been launched in one of its forms on one of
     them; the four-step proof ntt_mxu and no ntt; the sharded proof (rank
     0) no scan_madd, and point_scan_affine; the fixed-base proof must launch point_add, point_scan and
     point_row_sum under 100 times together, field_binop under 300 times,
     ntt at most 8 times and none of the chain kernels; each SHA-256
     proof quotient_forest once, and scan_madd and ntt; the RSA keygen
     K1's product, ntt and scan_madd, and none of the chain kernels; the
     variable-base proof no point_double, at most 7 point_horner and 10
     point_add; the table build no point_double and at most 2
     point_windows; the SRS no point_double and no point_add; the ragged
     MSM two point_scan_affine (its one local scan), three point_add (its
     one bucket extraction) and no point_add_mixed; each gate-level proof
     quotient_forest once and no point_double, the k=19 one ntt, scan_madd
     and field_scan; MockProver on the card field_binop's product and
     sum; the k=20 aggregation proof quotient_forest once, the transforms,
     the scans of field elements and of points and K6 and no chain kernel,
     its keygen K1's product, ntt and scan_madd and no chain kernel, its
     SRS and tables point_fixed_mul and 16 point_windows (17 where G's
     table is built on the way); the CLI's k=20 keygen at most one
     point_fixed_mul and 8 point_windows (its SRS and Lagrange table), its
     proof at most 8 point_windows (the monomial table) and its Keccak
     proof (the EVM flow, both tables cached) no chain kernel; the CLI's
     k=19 keygen at most one point_fixed_mul and 4 point_windows, its
     proof one quotient_forest and at most 4 point_windows; the proof
     under H2T_SELFCHECK=3 more K1 products and differences than the
     fixed-base proof, under H2T_EVAL_MODE=coeff more ntt; the CLI's 4096-bit RSA proof what the
     fixed-base proof launches (and at most 8 more ntt: the first proof
     with a key puts the key's columns on the extended domain) and no
     chain kernel, its first RSA proof
     the same with at most one point_windows (the monomial basis's table,
     built at its first use), each CLI SHA-256 proof quotient_forest once,
     scan_madd and ntt; each accumulator toy proof quotient_forest once.  The [shapes] lines give the shapes the
     point kernels, the transforms and the field scans were called with
     on each path.

Any failure exits non-zero.  The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}.  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
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


def device_generator(rng: np.random.Generator, device) -> torch.Generator:
    """A generator on `device` seeded from `rng`: every input of a kernel
    check is drawn on the card, where inputs of gigabytes take no host time
    or memory, and follows from the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 1 << 63)))
    return gen


def random_canonical(rng: np.random.Generator, count: int, device,
                     modulus: int) -> torch.Tensor:
    """(count, 8) uniform-ish canonical words, the first rows 0, 1, p - 1;
    drawn 2^24 rows at a time (a draw is int64 before it is words)."""
    gen = device_generator(rng, device)
    out = torch.empty((count, 8), dtype=torch.int32, device=device)
    for off in range(0, count, 1 << 24):
        w = torch.randint(0, 1 << 32, (min(1 << 24, count - off), 8),
                          dtype=torch.int64, generator=gen, device=device)
        w[:, 7] %= (modulus >> 224)                # top word below p's
        out[off:off + w.shape[0]] = w.to(torch.int32)
    edge = [[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
            for v in (0, 1, modulus - 1)][:count]
    if edge:
        out[:len(edge)] = torch.tensor(edge, dtype=torch.int64,
                                       device=device).to(torch.int32)
    return out


def random_picks(rng: np.random.Generator, pool: torch.Tensor,
                 shape) -> torch.Tensor:
    """Rows of `pool` picked at random into `shape`, drawn on its device."""
    idx = torch.randint(0, pool.shape[0], tuple(shape), device=pool.device,
                        generator=device_generator(rng, pool.device))
    return pool[idx].contiguous()


def sorted_digits(rng: np.random.Generator, blocks: int, rows: int, C: int,
                  device) -> torch.Tensor:
    """(blocks * rows, C) 16-bit window digits, each block of rows * C in
    ascending order as a column's sorted digits are."""
    d = torch.randint(0, 1 << 16, (blocks, rows * C), device=device,
                      generator=device_generator(rng, device))
    return d.sort(dim=1).values.to(torch.int32).reshape(blocks * rows, C)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _record(name, source, replaces, err, ms, plain_ms, bytes_moved, ops,
            counter=None):
    """`ms`: the pair `kernel_ms` gives.  `counter`: the key of
    ops/kernels.launches that the record's wrapper counts under, where
    several records (shapes, options) share one."""
    ms, issued_ms = ms
    bound_ms, bound_by = _bound(bytes_moved, ops)
    return {"name": name, "counter": counter or name, "route": "cuda",
            "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "issued_ms": issued_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _bound(bytes_moved, ops) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes' time at the
    memory rate and the 32-bit operations' at the peak rate."""
    bound_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_o = ops / OPS_PER_S * 1e3
    return max(bound_b, bound_o), ("bytes" if bound_b >= bound_o
                                   else "operations")


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


def _exact_records(src, cases, path=None) -> list:
    """Records of `cases`, (name, counter, replaces, kernel, plain, bytes,
    products) each, every kernel equal to its plain version word for word;
    `path`: the driven path whose launches the records report."""
    recs = []
    for name, counter, replaces, kern, plain, nbytes, products in cases:
        err = _exact(name, kern, plain)
        recs.append(_record(name, src, replaces, err, kernel_ms(kern, 10),
                            cuda_ms(plain, 2, 1), nbytes,
                            OPS_PER_MUL * products, counter))
        if path is not None:
            recs[-1]["path"] = path
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


def check_ntt(device, k: int, cols: int, rng, ek=None, path=None,
              plain_cols=None) -> list:
    """The transforms of one proof at their shapes: the inverse transform of
    `cols` fresh columns at 2^k, their coset transform onto the extended
    domain 2^ek (default k + 2) from 2^k coefficients, Montgomery form out,
    and the inverse coset transform of one Montgomery-form column there.  A
    transform is k / 2 products an element whatever implements it.
    `plain_cols`: run the plain versions on slices of that many columns
    (a transform is one column's), timed together."""
    from halo2_zkcert_tpu_torch.ops import ntt
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    n, g = 1 << k, rc.FR_GENERATOR
    ek = k + 2 if ek is None else ek
    a = random_canonical(rng, cols * n, device, FR.modulus).reshape(cols, n, 8)
    h = random_canonical(rng, 1 << ek, device, FR.modulus)[None]
    cases = (
        (f"ntt.inverse[{cols}x{n}]", lambda: ntt.intt(a, k),
         lambda c0, c1: ntt.intt_plain(a[c0:c1], k), k, cols, n, n),
        (f"ntt.coset.mont[{cols}x{n}->{1 << ek}]",
         lambda: ntt.coset_ntt(a, ek, g, out_mont=True),
         lambda c0, c1: ntt.coset_ntt_plain(a[c0:c1], ek, g, out_mont=True),
         ek, cols, n, 1 << ek),
        (f"ntt.coset_inverse.mont[1x{1 << ek}]",
         lambda: ntt.coset_intt(h, ek, g, in_mont=True),
         lambda c0, c1: ntt.coset_intt_plain(h, ek, g, in_mont=True), ek, 1,
         1 << ek, 1 << ek),
    )
    src, replaces = ("halo2_zkcert_tpu_torch/csrc/ntt.cu",
                     "halo2_zkcert_tpu/ops/pallas_limbs.py:435")
    if plain_cols is None:
        return _exact_records(
            src, [(name, "ntt", replaces, kern,
                   lambda plain=plain, B=B: plain(0, B),
                   32 * B * (n_in + n_out), B * n_out * kk // 2)
                  for name, kern, plain, kk, B, n_in, n_out in cases], path)
    recs = []
    for name, kern, plain, kk, B, n_in, n_out in cases:
        err, plain_ms = _sliced(name, kern, plain, B, plain_cols)
        recs.append(dict(_record(name, src, replaces, err,
                                 kernel_ms(kern, 5), plain_ms,
                                 32 * B * (n_in + n_out),
                                 OPS_PER_MUL * B * n_out * kk // 2, "ntt"),
                         path=path))
        torch.cuda.empty_cache()
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
    return _exact_records(src, cases)


def sample_affine(device, n: int, rng) -> torch.Tensor:
    """(n, 2, 8) affine points of G1 drawn from 64 host multiples of G."""
    from halo2_zkcert_tpu_torch.ops import curve
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    G = rc.g1_from_affine(rc.G1_GEN)
    aff = curve.points_to_device(
        [rc.g1_to_affine(rc.g1_mul(G, int(s)))
         for s in rng.integers(1, 1 << 62, size=64)], device)
    return random_picks(rng, aff, (n,))


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
        return random_picks(rng, aff, shape)

    def digits(R, C):
        return sorted_digits(rng, 1, R, C, device)

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


def check_quotient(device, cs, k: int, rng, name="quotient_forest",
                   path=None, plain_rows=None) -> dict:
    """K4 on the tape of constraint system `cs` at 2^k rows over random
    Montgomery-form leaves of its extended domain, against its plain
    version, exactly.  `path`: the driven path whose launches the record
    reports.  `plain_rows`: hold only the first that many rows to the plain
    version, run on that row slice with the rows its rotations read."""
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.plonk import quotient
    from halo2_zkcert_tpu_torch.plonk.domain import Domain
    dom = Domain(k, cs.quotient_degree, str(device))
    tape = quotient.compile_tape(cs, dom.n, dom.extended_n)
    L = len(quotient.leaf_layout(cs))
    ext_n = dom.extended_n
    leaves = random_canonical(rng, L * ext_n, device,
                              FR.modulus).reshape(L, ext_n, 8)
    chal = random_canonical(rng, tape.num_challenges, device, FR.modulus)
    consts = tape.const_table(chal)       # Montgomery form, as the leaves are
    got = quotient.quotient_forest(leaves, consts, tape)
    rows = ext_n if plain_rows is None else plain_rows
    ptape, pad, idx = tape, 0, slice(None)
    if rows < ext_n:
        # the same tape with its row offsets taken from (-ext_n/2, ext_n/2],
        # so that they read the same rows of a slice as of the whole column
        ins = tape.ins.copy()
        load = ins[:, 0] == quotient.LOAD
        off = ins[load, 3] % ext_n
        ins[load, 3] = np.where(off > ext_n // 2, off - ext_n, off)
        ptape = copy.copy(tape)
        ptape.ins = ins
        pad = int(np.abs(ins[load, 3]).max())
        idx = torch.arange(-pad, rows + pad, device=device) % ext_n
    want, plain_ms = timed_once(lambda: quotient.quotient_forest_plain(
        leaves[:, idx], consts, ptape))
    got_rows, want = got[:rows], want[pad:pad + rows]
    err = max_abs_err(got_rows, want)
    ok = torch.equal(got_rows, want)
    nmul = int((tape.ins[:, 0] == quotient.MUL).sum())
    log(f"[kernels] {name} ext_n={ext_n} leaves={L} "
        f"tape={len(tape.ins)} muls={nmul} slots={tape.num_slots}: "
        f"{'exact' if ok else 'MISMATCH'}"
        + ("" if rows == ext_n else f" on rows 0-{rows - 1} (plain "
           f"version on that slice, {pad} rows of rotation either side)"))
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    del want, got_rows, idx
    rec = _record(
        name, "halo2_zkcert_tpu_torch/csrc/quotient_forest.cu",
        "halo2_zkcert_tpu/plonk/quotient_pallas.py:315", err,
        kernel_ms(lambda: quotient.quotient_forest(leaves, consts, tape), 10),
        plain_ms,
        (L + 1) * ext_n * 32 + consts.numel() * 4,
        nmul * OPS_PER_MUL * ext_n, "quotient_forest")
    if rows < ext_n:
        rec["plain_rows"] = rows
    if path is not None:
        rec["path"] = path
    return rec


def _sliced(name, kern, plain, rows, step, mask=None):
    """kern() against plain(r0, r1) over slices of `step` rows of its
    result (under `mask` where given), word for word; the largest word
    difference and the plain versions' summed ms."""
    got, err, plain_ms = kern(), 0, 0.0
    for r0 in range(0, rows, step):
        want, ms = timed_once(lambda: plain(r0, r0 + step))
        g = got[r0:r0 + step]
        if mask is not None:
            g, want = g[mask[r0:r0 + step]], want[mask[r0:r0 + step]]
        if not torch.equal(g, want):
            raise AssertionError(f"{name} disagrees with its plain "
                                 f"version (err {max_abs_err(g, want)})")
        err, plain_ms = max(err, max_abs_err(g, want)), plain_ms + ms
    log(f"[kernels] {name}: exact"
        + ("" if mask is None else
           f" in the {int(mask.sum())} defined slots"))
    return err, plain_ms


def check_gate_shapes(device, rng) -> list:
    """The shapes that the k=19 gate-level path gives the kernels and no
    earlier record holds, each against its plain version word for word:
    the transforms of the proof's 29 fresh columns from 2^19 onto 2^20 and
    back, its 15 grand products and the batched inversion's 15 x 2^19 row
    (the suffix products), the row sums of 16 columns at 2^19, K6 over one
    commitment batch (4 columns x 16 windows x 2^19 pairs in rows of 64,
    each column's digits sorted; in the slots the digits define) and the
    SRS's 2^20 fixed-base products.  The plain versions of the last two
    run on row slices, timed together."""
    from halo2_zkcert_tpu_torch.ops import curve, frops, msm_fb
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.plonk import kzg
    proof, setup = "sha256_gate_cli_proof", "sha256_gate_cli_setup"
    recs = check_ntt(device, 19, 29, rng, ek=20, path=proof)
    n = 1 << 19
    mul, add = ("halo2_zkcert_tpu/ops/pallas_limbs.py:435",
                "halo2_zkcert_tpu/ops/pallas_limbs.py:441")
    x = random_canonical(rng, 16 * n, device, FR.modulus).reshape(16, n, 8)
    x[0, :3] = x[0, 3:6]                   # no zero in the product rows
    a15, row = x[:15], x[:15].reshape(1, 15 * n, 8)
    recs += _exact_records("halo2_zkcert_tpu_torch/csrc/field_scan.cu", (
        (f"field_scan.mul[15x{n}]", "field_scan", mul,
         lambda: frops.field_scan(a15, "mul"),
         lambda: frops.field_scan_plain(a15, "mul"), 64 * 15 * n,
         15 * (n - 1)),
        (f"field_scan.mul.reverse[1x{15 * n}]", "field_scan", mul,
         lambda: frops.field_scan(row, "mul", reverse=True),
         lambda: frops.field_scan_plain(row, "mul", reverse=True),
         64 * 15 * n, 15 * n - 1),
        (f"field_row_sum[16x{n}]", "field_row_sum", add,
         lambda: frops.field_row_sum(x),
         lambda: frops.tree_sum_batched_plain(x), 32 * 16 * (n + 1), 0),
    ), proof)
    del x, a15, row

    C, B = msm_fb.SCAN_ROW_MAX, 4
    R = 16 * n // C
    xy = sample_affine(device, B * R * C, rng).reshape(B * R, C, 2, 8)
    d = sorted_digits(rng, B, R, C, device)
    name = f"scan_madd.digits[{B * R}x{C}]"
    err, plain_ms = _sliced(name, lambda: msm_fb.scan_madd(xy, d),
                           lambda r0, r1: msm_fb.scan_madd_plain(xy[r0:r1]),
                           B * R, 1 << 15, msm_fb.scan_madd_defined(d))
    rec = _record(name, "halo2_zkcert_tpu_torch/csrc/scan_madd.cu",
                  "halo2_zkcert_tpu/ops/pallas_limbs.py:533", err,
                  kernel_ms(lambda: msm_fb.scan_madd(xy, d), 10), plain_ms,
                  5 * 32 * B * R * C, 11 * OPS_PER_MUL * B * R * C,
                  "scan_madd")
    recs.append(dict(rec, path=proof))
    del xy, d
    torch.cuda.empty_cache()

    table = kzg.g1_window_table(device)
    m = 2 * n
    s = random_canonical(rng, m, device, FR.modulus)
    s[5, :3] = 0                                # zero bytes among the others
    nonzero = int((s.view(torch.uint8) != 0).sum())
    name = f"point_fixed_mul[{m}]"
    err, plain_ms = _sliced(name, lambda: curve.fixed_mul(s, table),
                           lambda r0, r1: curve.fixed_mul_plain(s[r0:r1],
                                                                table),
                           m, 1 << 18)
    rec = _record(name, "halo2_zkcert_tpu_torch/csrc/point_chain.cu",
                  "halo2_zkcert_tpu/ops/pallas_limbs.py:393", err,
                  kernel_ms(lambda: curve.fixed_mul(s, table), 5), plain_ms,
                  table.numel() * 4 + (32 + 96) * m,
                  11 * OPS_PER_MUL * nonzero, "point_fixed_mul")
    recs.append(dict(rec, path=setup))
    return recs


def check_agg_shapes(device, rng) -> list:
    """The shapes that the k=20 aggregation path gives the kernels, each
    against its plain version word for word: the transforms of the proof's
    67 fresh columns from 2^20 onto 2^22 and back (the plain versions on
    slices of 4 columns), its 23 grand products (14 permutation chunks, 9
    lookups) and the batched inversion's 23 x 2^20 row, the row sums of 16
    columns at 2^20, K6 at the proof's launch shapes (a chunk of 2^21
    pairs in 65 536 rows of 32, and 4 x 65 548 rows of 64; each chunk's
    digits sorted; in the slots the digits define), the k=20 SRS's 2^21
    fixed-base products, and K4 on the aggregation key's tape over 2^22
    rows (157 leaves; the plain version on the first 2^18).  The window tables
    of 2^20 points are built in 2^17-point slices, phase 2's shape
    (`point_windows` there)."""
    from halo2_zkcert_tpu_torch.ops import curve, frops, msm_fb
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.plonk import kzg
    from halo2_zkcert_tpu_torch.sdk import read_vk
    proof, setup = "x509_agg_proof", "x509_agg_setup"
    recs = check_ntt(device, 20, 67, rng, ek=22, path=proof, plain_cols=4)
    n = 1 << 20
    mul, add = ("halo2_zkcert_tpu/ops/pallas_limbs.py:435",
                "halo2_zkcert_tpu/ops/pallas_limbs.py:441")
    x = random_canonical(rng, 23 * n, device, FR.modulus).reshape(23, n, 8)
    x[0, :3] = x[0, 3:6]                   # no zero in the product rows
    row = x.reshape(1, 23 * n, 8)
    recs += _exact_records("halo2_zkcert_tpu_torch/csrc/field_scan.cu", (
        (f"field_scan.mul[23x{n}]", "field_scan", mul,
         lambda: frops.field_scan(x, "mul"),
         lambda: frops.field_scan_plain(x, "mul"), 64 * 23 * n,
         23 * (n - 1)),
        (f"field_scan.mul.reverse[1x{23 * n}]", "field_scan", mul,
         lambda: frops.field_scan(row, "mul", reverse=True),
         lambda: frops.field_scan_plain(row, "mul", reverse=True),
         64 * 23 * n, 23 * n - 1),
        (f"field_row_sum[16x{n}]", "field_row_sum", add,
         lambda: frops.field_row_sum(x[:16]),
         lambda: frops.tree_sum_batched_plain(x[:16]), 32 * 16 * (n + 1),
         0),
    ), proof)
    del x, row
    torch.cuda.empty_cache()

    # K6 as the commitments launch it: one 2^21-pair chunk in rows of 32
    # (432 launches a proof), and four chunks of 65 548 rows of 64
    for B, R, C in ((1, 1 << 16, 32), (4, 65548, 64)):
        xy = sample_affine(device, B * R * C, rng).reshape(B * R, C, 2, 8)
        d = sorted_digits(rng, B, R, C, device)
        name = f"scan_madd.digits[{B * R}x{C}]"
        err, plain_ms = _sliced(
            name, lambda: msm_fb.scan_madd(xy, d),
            lambda r0, r1: msm_fb.scan_madd_plain(xy[r0:r1]), B * R,
            1 << 15, msm_fb.scan_madd_defined(d))
        rec = _record(name, "halo2_zkcert_tpu_torch/csrc/scan_madd.cu",
                      "halo2_zkcert_tpu/ops/pallas_limbs.py:533", err,
                      kernel_ms(lambda: msm_fb.scan_madd(xy, d), 10),
                      plain_ms, 5 * 32 * B * R * C,
                      11 * OPS_PER_MUL * B * R * C, "scan_madd")
        recs.append(dict(rec, path=proof))
        del xy, d
        torch.cuda.empty_cache()

    table = kzg.g1_window_table(device)
    m = 2 * n
    s = random_canonical(rng, m, device, FR.modulus)
    s[5, :3] = 0                                # zero bytes among the others
    nonzero = int((s.view(torch.uint8) != 0).sum())
    name = f"point_fixed_mul[{m}]"
    err, plain_ms = _sliced(name, lambda: curve.fixed_mul(s, table),
                            lambda r0, r1: curve.fixed_mul_plain(s[r0:r1],
                                                                 table),
                            m, 1 << 18)
    rec = _record(name, "halo2_zkcert_tpu_torch/csrc/point_chain.cu",
                  "halo2_zkcert_tpu/ops/pallas_limbs.py:393", err,
                  kernel_ms(lambda: curve.fixed_mul(s, table), 3), plain_ms,
                  table.numel() * 4 + (32 + 96) * m,
                  11 * OPS_PER_MUL * nonzero, "point_fixed_mul")
    recs.append(dict(rec, path=setup))
    del s
    torch.cuda.empty_cache()

    vk = read_vk(os.path.join(REPO, "build", "x509_agg.pk.vk"))
    recs.append(check_quotient(device, vk.cs, vk.k, rng,
                               "quotient_forest[x509_agg tape]", proof,
                               plain_rows=1 << 18))
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 3 and 4: SRS + key commitments, then the proof
# ---------------------------------------------------------------------------

class environ_set:
    """Set an environment variable for the block: H2T_FB_MSM "1" forces
    the fixed-base commitment MSM, "0" the variable base (plonk/kzg.py);
    PARAMS_DIR at a directory that does not exist keeps window tables off
    the disk."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.saved is None:
            del os.environ[self.name]
        else:
            os.environ[self.name] = self.saved


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
        with environ_set("H2T_FB_MSM", mode):
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


# ---------------------------------------------------------------------------
# phases 7-9: the host runtime, the builder, the gate-level SHA-256
# ---------------------------------------------------------------------------

def check_native(seed: int, card: str) -> None:
    """The host library (native.py) against its plain versions: the
    Poseidon permutation on 1000 seeded states (0, 1 and p - 1 among them),
    Keccak-256 at the rate's edges; the microseconds of a call of each."""
    from halo2_zkcert_tpu_torch import native
    from halo2_zkcert_tpu_torch.transcript.poseidon import permute_plain
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    rng = np.random.default_rng(seed)
    states = [[0, 0, 0], [1, 1, 1], [rc.FR - 1] * 3]
    while len(states) < 1000:
        states.append([int.from_bytes(rng.bytes(32), "little") % rc.FR
                       for _ in range(3)])
    same = all(native.poseidon_permute(s) == permute_plain(s)
               for s in states)
    lengths = (0, 1, 135, 136, 137, 1000)
    datas = [rng.bytes(n) for n in lengths]
    same_k = all(native.keccak256(d) == rc.keccak256(d) for d in datas)

    def us(fn, args):
        t0 = time.perf_counter()
        for a in args:
            fn(a)
        return (time.perf_counter() - t0) / len(args) * 1e6

    log(f"[native] poseidon_permute equals permute_plain on {len(states)} "
        f"states: {same}; keccak256 equals refcrypto.keccak256 at lengths "
        f"{list(lengths)}: {same_k}")
    log(f"[native] host microseconds a call ({card}): poseidon_permute "
        f"{us(native.poseidon_permute, states):.2f}, permute_plain "
        f"{us(permute_plain, states[:200]):.2f}; keccak256 of 1000 bytes "
        f"{us(native.keccak256, [datas[-1]] * 200):.2f}, plain "
        f"{us(rc.keccak256, [datas[-1]] * 20):.2f}")
    if not (same and same_k):
        raise AssertionError("the host library disagrees with its plain "
                             "versions")


def _fixture(name: str) -> dict:
    z = np.load(os.path.join(REPO, "tests", "data", name))
    return {"vk": json.loads(z["vk_json"].tobytes()),
            "instances": json.loads(z["instances_json"].tobytes()),
            "proof": z["proof_poseidon"].tobytes(),
            "mock": json.loads(z["mock_corrupted_json"].tobytes())
            if "mock_corrupted_json" in z.files else None}


def _keygen_and_prove(device, name, params, data, advice, instances, ref,
                      card, launches) -> tuple:
    """keygen and one proof with the default blinding seed; the commitments
    and the proof bytes held to `ref` (a fixture of the JAX package), the
    proof verified and a wrong instance rejected."""
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import (create_proof, keygen, prover,
                                              verify_proof)
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_to_dict
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    kernels.reset_launches()
    t0 = time.perf_counter()
    pk = keygen(params, data)
    torch.cuda.synchronize()
    t_key = time.perf_counter() - t0
    launches[f"{name}_keygen"] = dict(kernels.launches)
    vk = vk_to_dict(pk.vk)
    same_key = (vk["fixed_commitments"] == ref["vk"]["fixed_commitments"]
                and vk["permutation_commitments"]
                == ref["vk"]["permutation_commitments"]
                and vk["cs"] == ref["vk"]["cs"])
    log(f"[keygen] {name}: k={data.k}, {len(vk['fixed_commitments'])} fixed "
        f"+ {len(vk['permutation_commitments'])} sigma columns in "
        f"{t_key:.3f} s as issued ({card}): "
        f"{'equal to' if same_key else 'DIFFERENT FROM'} the JAX package's")
    if not same_key:
        raise AssertionError(f"{name}: key differs from the JAX package's")
    kernels.reset_launches()
    with recorded_shapes() as rec:
        t0 = time.perf_counter()
        proof = create_proof(params, pk, advice, instances,
                             PoseidonTranscript())
        dt = time.perf_counter() - t0
    launches[f"{name}_proof"] = dict(kernels.launches)
    same = proof == ref["proof"] and instances == ref["instances"]
    log(f"[prove] {name}: proof {dt:.3f} s as issued ({card}), "
        f"{len(proof)} bytes, "
        f"{'equal to' if same else 'DIFFERENT FROM'} the JAX package's, "
        f"stages {json.dumps(prover.LAST_STAGE_TIMES)}")
    log(f"[shapes] {name}_proof: {json.dumps(rec.shapes, sort_keys=True)}")
    if not same:
        raise AssertionError(f"{name}: proof bytes or instances differ from "
                             f"the JAX package's")
    ok = verify_proof(params, pk.vk, instances, proof, PoseidonTranscript)
    bad = [list(instances[0])]
    bad[0][-1] = (bad[0][-1] + 1) % rc.FR
    rejected = not verify_proof(params, pk.vk, bad, proof, PoseidonTranscript)
    log(f"[verify] {name}: accepts the proof: {ok}; rejects a wrong "
        f"instance: {rejected}")
    if not (ok and rejected):
        raise AssertionError(f"{name}: verifier check failed")
    return pk, proof


def builder_sample(device, card: str) -> dict:
    """The vertical-gate builder's sample circuit (tests/test_builder.py,
    a range check through a lookup) at k=8 on the card: keygen and a proof
    equal to tests/data/builder_reference.npz, MockProver on CUDA tensors
    satisfied, and a corrupted advice cell reported as the JAX package
    reports it."""
    sys.path.insert(0, os.path.join(REPO, "tests", "data"))
    from make_builder_reference import CORRUPT, K, build_sample
    from halo2_zkcert_tpu_torch.builder import GateBuilder
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import run_mock, setup
    ref = _fixture("builder_reference.npz")
    launches = {}
    data, advice, instances = build_sample(GateBuilder).finalize(
        K, device=device)
    _keygen_and_prove(device, "builder_sample", setup(K, device=device),
                      data, advice, instances, ref, card, launches)
    kernels.reset_launches()
    clean = run_mock(data, advice, instances, raise_on_failure=False)
    bad = advice.clone()
    col, row = CORRUPT
    bad[col, row, 0] += 1
    fails = run_mock(data, bad, instances, raise_on_failure=False)
    launches["builder_sample_mock"] = dict(kernels.launches)
    log(f"[mock] builder_sample on {advice.device}: {clean}; advice cell "
        f"{CORRUPT} plus one: {fails}")
    if clean or fails != ref["mock"]:
        raise AssertionError(f"builder_sample: MockProver verdicts differ "
                             f"from the JAX package's ({ref['mock']})")
    return launches


def sha256_gate_short(device, card: str) -> dict:
    """The gate-level SHA-256 of b"abc" at k=15 (13 advice columns, the
    constraint system of the CLI's size): the k=15 SRS and its tables on
    the card, keygen and a proof equal to
    tests/data/sha256_gate_reference.npz."""
    sys.path.insert(0, os.path.join(REPO, "tests", "data"))
    from make_sha256_gate_reference import K, MSG
    from halo2_zkcert_tpu_torch.circuits.sha256_gate import Sha256GateCircuit
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import setup
    ref = _fixture("sha256_gate_reference.npz")
    launches = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    params = setup(K, device=device)
    params.fixed_base(lagrange=True)
    params.fixed_base(lagrange=False)
    torch.cuda.synchronize()
    launches["sha256_gate_setup"] = dict(kernels.launches)
    log(f"[srs] k={K} and both window tables built on the card in "
        f"{time.perf_counter() - t0:.3f} s ({card})")
    circ = Sha256GateCircuit(MSG, k=K, device=device)
    _keygen_and_prove(device, "sha256_gate_short", params, circ.data,
                      circ.advice, circ.instances, ref, card, launches)
    return launches, circ.data.cs


def sha256_gate_cli(device, card: str) -> dict:
    """The gate-level SHA-256 of the reference CLI
    (`prove-unoptimized-sha256`): the 970-byte TBS of example_cert_3.pem at
    k=19.  The SRS and both window tables on the card, the circuit, keygen,
    MockProver on the card (satisfied), a proof that verifies and rejects a
    flipped byte, and instances equal to hashlib's digest.  No JAX proof of
    this size exists: bytes are held at k=15 (`sha256_gate_short`)."""
    import hashlib
    from halo2_zkcert_tpu_torch.cert import extract_tbs_and_sig, parse_pem
    from halo2_zkcert_tpu_torch.circuits.sha256_gate import Sha256GateCircuit
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import (create_proof, keygen, prover,
                                              run_mock, setup, verify_proof)
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    with open(os.path.join(REPO, "testdata", "example_cert_3.pem"), "rb") as f:
        tbs, _ = extract_tbs_and_sig(parse_pem(f.read()))
    launches, steps = {}, {}

    def step(label, path, fn):
        kernels.reset_launches()
        with recorded_shapes() as rec:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            steps[label] = time.perf_counter() - t0
        if path:
            launches[path] = dict(kernels.launches)
            log(f"[shapes] {path}: {json.dumps(rec.shapes, sort_keys=True)}")
        log(f"[sha256_gate_cli] {label}: {steps[label]:.3f} s ({card})")
        return out

    def srs():
        params = setup(19, device=device)
        params.fixed_base(lagrange=True)
        params.fixed_base(lagrange=False)
        return params

    params = step("srs and both window tables", "sha256_gate_cli_setup", srs)
    circ = step("circuit (record and pack on the host)", None,
                lambda: Sha256GateCircuit(tbs, k=19, device=device))
    cs = circ.data.cs
    log(f"[sha256_gate_cli] {len(tbs)}-byte TBS: {len(circ.gb.values)} cells, "
        f"{len(circ.data.copies)} copies, {cs.num_advice} advice, "
        f"{cs.num_fixed} fixed, {cs.num_instance} instance, "
        f"{len(cs.permutation_columns)} permutation columns, "
        f"{len(cs.lookups)} lookups")
    pk = step("keygen", "sha256_gate_cli_keygen",
              lambda: keygen(params, circ.data))
    fails = step("run_mock", "sha256_gate_cli_mock",
                 lambda: run_mock(circ.data, circ.advice, circ.instances,
                                  raise_on_failure=False))
    log(f"[mock] sha256_gate_cli on {circ.advice.device}: {fails[:5]}")
    if fails:
        raise AssertionError(f"sha256_gate_cli: MockProver: {fails[:5]}")
    proof = step("proof", "sha256_gate_cli_proof",
                 lambda: create_proof(params, pk, circ.advice, circ.instances,
                                      PoseidonTranscript()))
    log(f"[prove] sha256_gate_cli: {len(proof)} bytes, stages "
        f"{json.dumps(prover.LAST_STAGE_TIMES)}")
    ok = step("verify", None, lambda: verify_proof(
        params, pk.vk, circ.instances, proof, PoseidonTranscript))
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    try:
        rejected = not verify_proof(params, pk.vk, circ.instances, bytes(bad),
                                    PoseidonTranscript)
    except (AssertionError, ValueError):
        rejected = True                           # an undecodable point
    digest = circ.instances == [list(hashlib.sha256(tbs).digest())]
    log(f"[verify] sha256_gate_cli: accepts the proof: {ok}; rejects a "
        f"flipped byte: {rejected}; instances equal hashlib's digest: "
        f"{digest}")
    if not (ok and rejected and digest):
        raise AssertionError("sha256_gate_cli: verifier or digest check "
                             "failed")
    # phase 15 at k=19: the identity at x, and K4's 48-slot rematerialized
    # tape held to the exact oracle over 8 extended rows
    for level in ("1", "4"):
        again, dt, _, verdicts = knob_proof(
            ("H2T_SELFCHECK", level), lambda: create_proof(
                params, pk, circ.advice, circ.instances, PoseidonTranscript()))
        log(f"[knobs] sha256_gate_cli, H2T_SELFCHECK={level}: proof {dt:.3f} "
            f"s (checks included), {'equal to' if again == proof else 'DIFFERENT FROM'} "
            f"the proof above; verdicts {json.dumps(verdicts)} ({card})")
        want = dict.fromkeys(selfcheck_labels(("H2T_SELFCHECK", level),
                                              pk.vk.cs), "OK")
        if again != proof or verdicts != want:
            raise AssertionError(f"sha256_gate_cli: H2T_SELFCHECK={level}: "
                                 f"{verdicts}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the X.509 aggregation at k=20
# ---------------------------------------------------------------------------

def x509_agg(device, card: str, snark_dir: str, work: str) -> dict:
    """The reference CLI's aggregation (k=20, lanes 8, na 8, nl 1,
    fixed-vk mode) over the four inner snarks in `snark_dir` (the CLI
    chain's, phase 12, which equal the committed build/*.proof).  First the
    circuit as the JAX package records it (`keep_identity_terms=True`),
    through the calls the CLI makes: its record pass, the k=20 SRS and
    both window tables, `sdk.gen_pk` (the vk held field for field to
    build/x509_agg.pk.vk), both phases' advice columns held to
    tests/data/aggregation_reference.npz at its tau, MockProver on that
    pass satisfied, and its accumulator failing the deferred pairing (the
    identity commitments of the SHA-256 vks, circuits/agg_loader.py).  Each
    step's wall seconds and peak device memory.  Then the port's circuit
    through the CLI's three aggregation subcommands (`cli_aggregation`),
    its files in `work`."""
    sys.path.insert(0, os.path.join(REPO, "tests", "data"))
    import make_aggregation_reference as ref
    from halo2_zkcert_tpu_torch import sdk
    from halo2_zkcert_tpu_torch.circuits.aggregation import (
        InnerSnark, decode_accumulator)
    from halo2_zkcert_tpu_torch.circuits.x509_agg import \
        X509VerifierAggregationCircuit
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import run_mock, setup
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_to_dict
    from halo2_zkcert_tpu_torch.plonk.mock import mock_challenges
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    launches, steps = {}, {}
    torch.cuda.init()

    def step(label, path, fn):
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        with recorded_shapes() as rec:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            steps[label] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        if path:
            launches[path] = dict(kernels.launches)
            log(f"[shapes] {path}: {json.dumps(rec.shapes, sort_keys=True)}")
        log(f"[x509_agg] {label}: {steps[label]:.3f} s, device memory at "
            f"its peak {peak:.2f} GB ({card})")
        return out

    def record(label):
        circ = step(f"{label}: circuit (record pass on the host)", None,
                    lambda: X509VerifierAggregationCircuit(
                        inner, k=ref.K_X509, lanes=ref.LANES_X509,
                        na=ref.NA_X509, keep_identity_terms=True))
        cs, rep = circ.data.cs, circ.rows_report()
        log(f"[x509_agg] {label}: record "
            f"{circ.composed.pass_seconds[0][0]:.3f} s, packing "
            f"{circ.composed.pass_seconds[0][1]:.3f} s: "
            f"{rep['builder_cells']} builder cells, "
            f"{len(circ.data.copies)} copies, tape rows "
            f"{min(rep['tape_rows'])}-{max(rep['tape_rows'])} a lane of "
            f"{rep['usable']}; {cs.num_advice} advice, {cs.num_fixed} fixed, "
            f"{cs.num_instance} instance, {len(cs.permutation_columns)} "
            f"permutation columns, {len(cs.lookups)} lookups")
        return circ

    def pairing(instances) -> bool:
        lhs, rhs = decode_accumulator(instances)
        return rc.pairing_check([
            (lhs, params.s_g2),
            (rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(rhs))), params.g2)])

    def srs():
        params = setup(ref.K_X509, device=device)
        # built on the card every run: 2^20 points, 1.07 GB a basis
        with environ_set("PARAMS_DIR", os.path.join(REPO, "no-such-dir")):
            params.fixed_base(lagrange=True)
            params.fixed_base(lagrange=False)
        return params

    inner = []
    for stem in ref.X509_STEMS:
        s = sdk.Snark.read(os.path.join(snark_dir, f"{stem}.proof"))
        inner.append(InnerSnark(vk=s.vk, instances=s.instances,
                                proof=s.proof))
    with open(os.path.join(REPO, "build", "x509_agg.pk.vk")) as f:
        sidecar = json.load(f)
    keys = ("k", "num_instance", "accumulator_indices", "cs",
            "fixed_commitments", "permutation_commitments")

    # the JAX package's circuit, held to build/x509_agg.pk.vk and to the
    # JAX package's columns
    jcirc = record("JAX package's circuit")
    params = step("srs and both window tables", "x509_agg_setup", srs)
    jpk = step("JAX package's circuit: keygen (sdk.gen_pk)", None,
               lambda: sdk.gen_pk(params, jcirc.data))
    got = json.loads(json.dumps(vk_to_dict(jpk.vk)))
    same = {key: got[key] == sidecar[key] for key in keys}
    same["cache_digest"] = (jcirc.data.cache_digest_bytes().hex()
                            == sidecar["cache_digest"])
    log(f"[x509_agg] JAX package's circuit: vk with "
        f"{len(got['fixed_commitments'])} fixed and "
        f"{len(got['permutation_commitments'])} permutation commitments; "
        f"equal to build/x509_agg.pk.vk: {json.dumps(same, sort_keys=True)}")
    if not all(same.values()):
        raise AssertionError(f"x509_agg: vk differs from "
                             f"build/x509_agg.pk.vk: {same}")
    del jpk
    want = ref.load_record("x509")
    jfn, jinst = jcirc.witness(device)
    tau = int(want["tau"])
    assert tau == mock_challenges(jcirc.data.cs)[0], "the fixture's tau"

    def digests(phase, ch):
        return {str(i): ref.words_digest(v.cpu())
                for i, v in sorted(jfn(phase, ch).items())}

    cols = step("JAX package's circuit: both phases' columns at the "
                "fixture's tau", None,
                lambda: (digests(0, {}), digests(1, {0: tau})))
    same = {"phase0": cols[0] == want["phase0"],
            "phase1": cols[1] == want["phase1"],
            "instances": [[str(v) for v in c] for c in jinst]
            == want["instances"]}
    fails_pairing = not pairing(jinst)
    log(f"[x509_agg] JAX package's circuit: {len(cols[0])} phase-0 and "
        f"{len(cols[1])} phase-1 columns, instances: equal to the JAX "
        f"package's (tests/data/aggregation_reference.npz): "
        f"{json.dumps(same, sort_keys=True)}; its accumulator fails the "
        f"deferred pairing: {fails_pairing}")
    if not (all(same.values()) and fails_pairing):
        raise AssertionError(f"x509_agg: the JAX package's circuit: {same}, "
                             f"accumulator fails the pairing: "
                             f"{fails_pairing}")
    fails = step("JAX package's circuit: run_mock (on that pass)", None,
                 lambda: run_mock(jcirc.data, jfn, jinst,
                                  raise_on_failure=False))
    log(f"[mock] x509_agg, the JAX package's circuit: {fails[:5]}")
    if fails:
        raise AssertionError(f"x509_agg: MockProver on the JAX package's "
                             f"circuit: {fails[:5]}")
    del jcirc, jfn
    # the subcommands build and cache their own tables
    for attr in ("_fb_lagrange", "_fb_monomial"):
        params.__dict__.pop(attr, None)
    torch.cuda.empty_cache()

    # the port's circuit, through the CLI's three aggregation subcommands
    launches.update(cli_aggregation(device, card, params, snark_dir, work,
                                    sidecar))
    return launches


def cli_aggregation(device, card: str, params, snark_dir: str, work: str,
                    sidecar: dict) -> dict:
    """Phase 10, the port's circuit, through `cli.main` on the card (k=20,
    lanes 8, na 8, over the four snark files of `snark_dir`, its build and
    params directories in `work`): gen-x509-agg-keys (the SRS set up and
    written, keygen, the key file written: its constraint system that of
    build/x509_agg.pk.vk), gen-x509-agg-proof and gen-x509-agg-evm-proof,
    each reading that key file and making none.  The proof subcommand's
    `cli.aggregation_step` is wrapped so that MockProver on the card runs
    first on the circuit it recorded (its launches apart).  Its snark file
    passes `verify_aggregated` and fails it with a byte flipped; the EVM
    flow's checks are `x509_agg_evm`'s.  Each subcommand's wall seconds and
    peak device memory; the key file's bytes, write and read seconds and
    host memory."""
    import make_aggregation_reference as ref
    from halo2_zkcert_tpu_torch import cli, sdk
    from halo2_zkcert_tpu_torch.circuits.aggregation import verify_aggregated
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import prover, run_mock
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    build, params_dir = os.path.join(work, "build"), os.path.join(work, "params")
    pk_path = os.path.join(build, "x509_agg.pk")
    proof_path = os.path.join(work, "x509_agg.proof")
    evm_path = os.path.join(work, "x509_agg_evm.proof")
    sol_path = os.path.join(work, "X509AggregationVerifierFinal.sol")
    common = ["--k", str(ref.K_X509), "--lanes", str(ref.LANES_X509),
              "--na", str(ref.NA_X509), "--snarks"] + [
        os.path.join(snark_dir, f"{stem}.proof") for stem in ref.X509_STEMS] + [
        "--pk-path", pk_path, "--build-dir", build, "--params-path",
        params_dir, "--device", str(device.type)]
    launches, seconds, caught = {}, {}, {}
    real_step, real_proof = cli.aggregation_step, sdk.create_proof

    def step(cmd, params_, pk, circuit, proof_path_, sol_path_=None,
             device_="cuda"):
        """cli.aggregation_step, MockProver first for the proof."""
        caught.update(vk=pk.vk, circuit_pass=circuit.composed.pass_seconds)
        if cmd == "gen-x509-agg-proof":
            witness_fn, instances = circuit.witness(device_)
            kernels.reset_launches()
            t0 = time.perf_counter()
            fails = run_mock(circuit.data, witness_fn, instances,
                             raise_on_failure=False)
            torch.cuda.synchronize()
            launches["x509_agg_mock"] = dict(kernels.launches)
            log(f"[mock] x509_agg: {fails[:5]} in "
                f"{time.perf_counter() - t0:.3f} s (its phase-1 pass and the "
                f"check on the card; {card})")
            if fails:
                raise AssertionError(f"x509_agg: MockProver: {fails[:5]}")
            del witness_fn
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        caught["out"] = real_step(cmd, params_, pk, circuit, proof_path_,
                                  sol_path_, device_)
        return caught["out"]

    def proof_alone(*args, **kwargs):
        """sdk.create_proof, its own device peak apart: the memory held
        when it starts (key, SRS, window tables) and its peak."""
        torch.cuda.synchronize()
        caught["peak_before_proof"] = torch.cuda.max_memory_allocated(device)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = real_proof(*args, **kwargs)
        torch.cuda.synchronize()
        log(f"[x509_agg] create_proof: {held / 1e9:.2f} GB held on the card "
            f"when it starts, {torch.cuda.max_memory_allocated(device) / 1e9:.2f}"
            f" GB at its peak ({card})")
        return out

    def run(label, argv, path):
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        caught["peak_before_proof"] = 0
        with recorded_shapes() as rec:
            t0 = time.perf_counter()
            cli.main(argv + common)
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
        launches[path] = dict(kernels.launches)
        peak = max(caught["peak_before_proof"],
                   torch.cuda.max_memory_allocated(device)) / 1e9
        log(f"[shapes] {path}: {json.dumps(rec.shapes, sort_keys=True)}")
        log(f"[x509_agg] {label}: {seconds[label]:.3f} s, device memory at "
            f"the peak of its step (`cli.aggregation_step`, or all of it "
            f"for the keys) {peak:.2f} GB ({card})")

    with environ_set("PARAMS_DIR", params_dir), key_files(card) as keys:
        run("gen-x509-agg-keys", ["gen-x509-agg-keys"], "x509_agg_keygen")
        if keys.keygens != 1:
            raise AssertionError(f"gen-x509-agg-keys: {keys.keygens} keygens")
        with open(pk_path + ".vk") as f:
            got = json.load(f)
        same = {key: got[key] == sidecar[key] for key in
                ("k", "num_instance", "accumulator_indices", "cs")}
        differ = {key: sum(a != b for a, b in zip(got[key], sidecar[key]))
                  for key in ("fixed_commitments", "permutation_commitments")}
        log(f"[x509_agg] port's circuit: vk equal to build/x509_agg.pk.vk in "
            f"{json.dumps(same, sort_keys=True)}; commitments that differ: "
            f"{json.dumps(differ, sort_keys=True)}")
        if not all(same.values()):
            raise AssertionError(f"x509_agg: constraint system differs from "
                                 f"build/x509_agg.pk.vk's: {same}")
        keys.reads = keys.keygens = 0
        cli.aggregation_step, sdk.create_proof = step, proof_alone
        try:
            run("gen-x509-agg-proof", ["gen-x509-agg-proof", "--proof-path",
                                       proof_path], "x509_agg_proof")
            keys.read_not_made("gen-x509-agg-proof", pk_path)
            snark = sdk.Snark.read(proof_path)
            log(f"[prove] x509_agg: record "
                f"{caught['circuit_pass'][-1][0]:.3f} s, packing "
                f"{caught['circuit_pass'][-1][1]:.3f} s; steps (s) "
                f"{json.dumps(caught['out']['seconds'])}; stages "
                f"{json.dumps(prover.LAST_STAGE_TIMES)}; {len(snark.proof)} "
                f"bytes, blake2b {rc.blake2b(snark.proof, 32).hex()}")
            check_snark("x509_agg (verify_aggregated)", params, snark,
                        verify=lambda s: verify_aggregated(
                            params, s.vk, s.instances, s.proof,
                            PoseidonTranscript))
            run("gen-x509-agg-evm-proof", ["gen-x509-agg-evm-proof",
                                           "--proof-path", evm_path,
                                           "--sol-path", sol_path],
                "x509_agg_evm_proof")
            keys.read_not_made("gen-x509-agg-evm-proof", pk_path)
        finally:
            cli.aggregation_step, sdk.create_proof = real_step, real_proof
    log(f"[x509_agg] subcommands (s, {card}): {json.dumps(seconds)}")
    log(f"[x509_agg] key file ({card}): {json.dumps(keys.files)}")
    x509_agg_evm(card, params, caught["vk"], caught["out"],
                 caught["circuit_pass"], evm_path, sol_path)
    return launches


# ---------------------------------------------------------------------------
# phase 10, continued: the aggregation's EVM flow; phase 12: the reference
# CLI's chain; the accumulator toy
# ---------------------------------------------------------------------------

def _evm_reference():
    """tests/data/make_evm_reference.py (module) and the JAX package's
    EVM artifacts it wrote (tests/data/evm_reference.json)."""
    sys.path.insert(0, os.path.join(REPO, "tests", "data"))
    import make_evm_reference as ref
    with open(ref.OUT) as f:
        return ref, json.load(f)


def evm_artifacts(params, card: str) -> None:
    """The IR, bytecode and Solidity of the toy vk and of
    build/{rsa_1,rsa_2,sha256_1,sha256_2,x509_agg}.pk.vk, emitted by the
    port with `params`' G2 points, held to the JAX package's digests; the
    toy fixture's Keccak proof accepted by the port's EVM with the JAX
    EVM's gas."""
    from halo2_zkcert_tpu_torch import evm
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    ref, want = _evm_reference()
    g2 = [[str(v) for v in c] for c in params.g2]
    s_g2 = [[str(v) for v in c] for c in params.s_g2]
    if (g2, s_g2) != (want["g2"], want["s_g2"]):
        raise AssertionError("evm: the SRS's G2 points differ from the JAX "
                             "package's")
    vks = {name: vk_from_dict(d) for name, d in ref.vk_dicts().items()}
    for name, vk in vks.items():
        t0 = time.perf_counter()
        got = ref.artifact_record(evm, rc, params, vk, name)
        dt = time.perf_counter() - t0
        same = got == want["vks"][name]
        log(f"[evm] {name}: {got['num_ops']} IR ops, proof "
            f"{got['proof_len']} bytes, runtime {got['runtime_len']} bytes, "
            f"Solidity {got['sol_len']} chars, emitted in {dt:.3f} s; IR, "
            f"bytecode and Solidity {'equal to' if same else 'DIFFERENT FROM'}"
            f" the JAX package's (blake2b deploy {got['deploy_blake2b']}, "
            f"sol {got['sol_blake2b']})")
        if not same:
            raise AssertionError(f"evm: {name}'s artifacts differ from the "
                                 f"JAX package's: {got} {want['vks'][name]}")
    instances, proof = ref.toy_keccak()
    t0 = time.perf_counter()
    got = evm.evm_verify_bytecode(params, vks["toy"], instances, proof)
    dt = time.perf_counter() - t0
    log(f"[evm] toy Keccak proof in the port's EVM: accepted {got[0]}, gas "
        f"{got[1]} (the JAX EVM's: {want['toy_keccak']['gas']}), "
        f"{dt:.3f} s on the host ({card})")
    if list(got) != [True, want["toy_keccak"]["gas"]]:
        raise AssertionError(f"evm: the toy Keccak proof: {got}")


def x509_agg_evm(card: str, params, vk, out: dict, circuit_pass: list,
                 proof_path: str, sol_path: str) -> None:
    """The checks of the CLI's `gen-x509-agg-evm-proof` on the port's k=20
    key, from what its `cli.aggregation_step` returned (`out`: the
    instances, the Keccak proof, its witness a fresh phase-1 pass at the
    Keccak transcript's tau, the Solidity verifier and each step's
    seconds) and the files it wrote: `verify_aggregated` with the Keccak
    transcript, the gas and the interpreter's seconds, `execute_ir`'s
    verdict, and the EVM's on a flipped byte, a changed instance and a
    proof cut short by 32 bytes; then the artifacts of the JAX package's
    vks (`evm_artifacts`)."""
    from halo2_zkcert_tpu_torch import evm
    from halo2_zkcert_tpu_torch.circuits.aggregation import verify_aggregated
    from halo2_zkcert_tpu_torch.plonk import prover
    from halo2_zkcert_tpu_torch.transcript import KeccakTranscript
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    instances, proof, sol = out["instances"], out["proof"], out["sol"]
    with open(proof_path, "rb") as f:
        on_disk = f.read() == proof
    with open(sol_path) as f:
        on_disk = on_disk and f.read() == sol
    log(f"[x509_agg_evm] gen-x509-agg-evm-proof: steps (s) "
        f"{json.dumps(out['seconds'])} ({card}); record "
        f"{circuit_pass[-1][0]:.3f} s, packing {circuit_pass[-1][1]:.3f} s; "
        f"proof stages {json.dumps(prover.LAST_STAGE_TIMES)}; {len(proof)} "
        f"bytes, blake2b {rc.blake2b(proof, 32).hex()}; Solidity {len(sol)} "
        f"chars, blake2b {rc.blake2b(sol.encode(), 32).hex()}; files as "
        f"returned: {on_disk}")
    rows = [len(c) for c in instances]
    t0 = time.perf_counter()
    agg_ok = verify_aggregated(params, vk, instances, proof,
                               KeccakTranscript)
    t_agg = time.perf_counter() - t0
    art = evm.gen_evm_verifier_bytecode(params, vk, rows)
    t0 = time.perf_counter()
    evm_ok, gas = evm.evm_verify_bytecode(params, vk, instances, proof)
    t_evm = time.perf_counter() - t0
    ops, _ = evm.build_verifier_ir(vk, rows)
    t0 = time.perf_counter()
    ir_ok = evm.execute_ir(ops, instances, proof, params)
    t_ir = time.perf_counter() - t0
    tags = [op[0] for op in ops]
    log(f"[x509_agg_evm] verify_aggregated (Keccak): {agg_ok} in "
        f"{t_agg:.3f} s; the EVM accepts: {evm_ok}, gas {gas}, deployed "
        f"runtime {len(art['runtime'])} bytes ({len(art['deploy'])} with "
        f"the constructor), {art['num_ops']} IR ops ({tags.count('comb128')} "
        f"comb128, last {tags[-1]}), interpreter {t_evm:.3f} s; execute_ir: "
        f"{ir_ok} in {t_ir:.3f} s ({card})")
    if not (on_disk and agg_ok and evm_ok and ir_ok
            and tags[-1] == "final_acc"):
        raise AssertionError("x509_agg_evm: the EVM flow's checks failed")
    flipped = bytearray(proof)
    flipped[len(flipped) // 2] ^= 1
    changed = [[(instances[0][0] + 1) % rc.FR] + list(instances[0][1:])] \
        + [list(c) for c in instances[1:]]
    tampered = {"flipped byte": (instances, bytes(flipped)),
                "changed instance": (changed, proof),
                "cut short by 32 bytes": (instances, proof[:-32])}
    verdicts = {}
    for what, (inst, bad) in tampered.items():
        t0 = time.perf_counter()
        ok, gas_bad = evm.evm_verify_bytecode(params, vk, inst, bad)
        verdicts[what] = {"accepted": ok, "gas": gas_bad,
                          "s": round(time.perf_counter() - t0, 3)}
    log(f"[x509_agg_evm] the EVM on tampered inputs: "
        f"{json.dumps(verdicts, sort_keys=True)}")
    if any(v["accepted"] for v in verdicts.values()):
        raise AssertionError(f"x509_agg_evm: a tampered input accepted: "
                             f"{verdicts}")
    evm_artifacts(params, card)


def toy_accumulator(device, card: str) -> dict:
    """The accumulator toy (tests/data/make_evm_reference.py `acc_toy`, k=6,
    its 8 instance rows an accumulator pair) keyed and proved on the card
    with `sdk.gen_evm_proof` for a good pair (P, tau P) and a bad one
    (P, (tau + 1) P): `verify_proof` accepts both, the EVM (`evm_verify`)
    and `execute_ir` accept the good and reject the bad, as
    `verify_aggregated` does.  The launch counts of each proof."""
    from halo2_zkcert_tpu_torch import evm, sdk
    from halo2_zkcert_tpu_torch.circuits.aggregation import verify_aggregated
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import keygen, setup, verify_proof
    from halo2_zkcert_tpu_torch.transcript import KeccakTranscript
    ref, _ = _evm_reference()
    params = setup(ref.ACC_K, device=device)
    launches = {}
    for good in (True, False):
        label = f"acc_toy_{'good' if good else 'bad'}"
        data, advice, instances = ref.acc_toy(ref.acc_pair(good), device)
        pk = keygen(params, data)
        kernels.reset_launches()
        with recorded_shapes() as rec:
            t0 = time.perf_counter()
            proof = sdk.gen_evm_proof(params, pk, advice, instances)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches[f"{label}_proof"] = dict(kernels.launches)
        log(f"[shapes] {label}_proof: {json.dumps(rec.shapes, sort_keys=True)}")
        verdict = {
            "verify_proof": verify_proof(params, pk.vk, instances, proof,
                                         KeccakTranscript),
            "verify_aggregated": verify_aggregated(
                params, pk.vk, instances, proof, KeccakTranscript),
            "evm_verify": sdk.evm_verify(params, pk.vk, instances, proof),
            "execute_ir": evm.execute_ir(
                evm.build_verifier_ir(pk.vk, [8])[0], instances, proof,
                params)}
        log(f"[acc_toy] {label}: gen_evm_proof {dt:.3f} s ({card}), "
            f"{len(proof)} bytes; {json.dumps(verdict, sort_keys=True)}")
        want = {"verify_proof": True, "verify_aggregated": good,
                "evm_verify": good, "execute_ir": good}
        if verdict != want:
            raise AssertionError(f"{label}: {verdict}, wanted {want}")
    return launches


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class PeakRss:
    """The process's resident bytes on entry and at their peak inside,
    sampled every 20 ms by a thread."""

    def __enter__(self):
        import threading
        self.before = self.peak = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def _watch(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


class key_files:
    """sdk's `write_pk`, `read_pk` and `keygen` wrapped for the block, as
    `sdk.gen_pk` calls them: each key file written or read is timed, with
    its bytes and the host's resident memory before and at its peak
    (`.files`, logged); `.keygens` and `.reads` count the calls."""

    def __init__(self, card: str):
        self.card, self.files = card, {}
        self.keygens = self.reads = 0

    def __enter__(self):
        from halo2_zkcert_tpu_torch import sdk
        self.saved = {k: getattr(sdk, k) for k in ("write_pk", "read_pk",
                                                   "keygen")}
        write_pk, read_pk, keygen = (self.saved[k] for k in
                                     ("write_pk", "read_pk", "keygen"))

        def timed(what, path, fn):
            with PeakRss() as m:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            size = os.path.getsize(path + ".npz")
            rec = {"npz_bytes": size, "s": dt, "rss_before": m.before,
                   "rss_peak": m.peak}
            self.files.setdefault(os.path.basename(path), {})[what] = rec
            log(f"[cli] key file {os.path.basename(path)}.npz: {size} bytes, "
                f"{what} in {dt:.3f} s, host RSS {m.before / 1e9:.3f} GB "
                f"before, {m.peak / 1e9:.3f} GB at its peak ({self.card})")
            return out

        def timed_write(pk, path, cache_digest=None):
            raw = sum(getattr(pk, k).shape[0] for k in sdk.PK_ARRAYS) \
                * pk.fixed_lagrange.shape[1] * 33 * 4
            log(f"[cli] key file {os.path.basename(path)}.npz: {raw} bytes "
                f"of limbs to write")
            return timed("written", path,
                         lambda: write_pk(pk, path, cache_digest))

        def timed_read(path, device="cuda", cs=None):
            self.reads += 1
            return timed("read", path, lambda: read_pk(path, device, cs))

        def counted_keygen(params, data):
            self.keygens += 1
            return keygen(params, data)

        sdk.write_pk, sdk.read_pk, sdk.keygen = (timed_write, timed_read,
                                                 counted_keygen)
        return self

    def __exit__(self, *exc):
        from halo2_zkcert_tpu_torch import sdk
        for k, fn in self.saved.items():
            setattr(sdk, k, fn)

    def read_not_made(self, label: str, path: str) -> None:
        """Since the counts were zeroed: the key read once, no keygen."""
        ok = self.reads == 1 and self.keygens == 0
        log(f"[cli] {label}: the key at {os.path.basename(path)} read from "
            f"its file ({self.reads} read), not made again ({self.keygens} "
            f"keygen): {ok}")
        if not ok:
            raise AssertionError(f"{label}: key reads {self.reads}, keygens "
                                 f"{self.keygens}")
        self.reads = self.keygens = 0


# the reference CLI's chain: (stem, signed certificate, issuer) of the RSA
# links and (stem, certificate) of the SHA-256 links
CLI_RSA = (("rsa_1", "example_cert_3.pem", "example_cert_2.pem"),
           ("rsa_2", "example_cert_2.pem", "example_cert_1.pem"))
CLI_SHA = (("sha256_1", "example_cert_3.pem"),
           ("sha256_2", "example_cert_2.pem"))


def cli_chain(device, card: str, work: str) -> dict:
    """Phase 12: the reference CLI's chain through `cli.main` on the card,
    its build and params directories in `work`, the certificates from
    testdata/: gen-params --k 17; gen-rsa-keys and prove-rsa for both RSA
    links (the 4096-bit root's included); gen-zkevm-sha256-keys and
    prove-zkevm-sha256 for both SHA-256 links; gen-unoptimized-sha256-keys
    and prove-unoptimized-sha256 for the TBS of example_cert_3.pem at k=19.
    Each snark file of the first four equals build/<stem>.proof in its
    proof bytes, instances and vk, and each key's vk build/<stem>.pk.vk in
    its commitments, constraint system and cache digest (where that sidecar
    has one); the k=19 snark verifies, is rejected with a byte flipped,
    and its instances are hashlib's digest.  Each prove subcommand reads
    the key its keys subcommand wrote and makes none.  Each subcommand's
    wall seconds, each key file's bytes, write and read seconds and host
    memory (`key_files`); the launch counts of each subcommand."""
    import hashlib
    from halo2_zkcert_tpu_torch import cli, sdk
    from halo2_zkcert_tpu_torch.cert import (extract_public_key,
                                             extract_tbs_and_sig, parse_pem)
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import prover
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_to_dict
    from halo2_zkcert_tpu_torch.plonk.kzg import gen_srs
    build, params_dir = os.path.join(work, "build"), os.path.join(work, "params")
    testdata = os.path.join(REPO, "testdata")
    common = ["--build-dir", build, "--params-path", params_dir,
              "--device", str(device.type)]
    launches, seconds = {}, {}

    def run(label, argv, path=None):
        kernels.reset_launches()
        with recorded_shapes() as rec:
            t0 = time.perf_counter()
            cli.main(argv + common)
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
        launches[path or f"cli_{label}"] = dict(kernels.launches)
        if path:
            log(f"[shapes] {path}: {json.dumps(rec.shapes, sort_keys=True)}")
        log(f"[cli] {label}: {seconds[label]:.3f} s ({card})")

    def held(stem):
        """The snark file and the key's vk against the committed ones."""
        got = sdk.Snark.read(os.path.join(build, f"{stem}.proof"))
        ref = sdk.Snark.read(os.path.join(REPO, "build", f"{stem}.proof"))
        with open(os.path.join(build, f"{stem}.pk.vk")) as f:
            key = json.load(f)
        with open(os.path.join(REPO, "build", f"{stem}.pk.vk")) as f:
            ref_key = json.load(f)
        same = {"proof": got.proof == ref.proof,
                "instances": got.instances == ref.instances,
                "vk": json.loads(json.dumps(vk_to_dict(got.vk)))
                == json.loads(json.dumps(vk_to_dict(ref.vk)))}
        # build/rsa_2.pk.vk is a sidecar without a cache digest (the JAX
        # package wrote it before it kept one); tests/test_torch_rsa.py
        # holds that circuit's digest to the JAX package's
        same.update({f"pk.vk {key_name}": key.get(key_name)
                     == ref_key.get(key_name)
                     for key_name in ("fixed_commitments",
                                      "permutation_commitments", "cs",
                                      "cache_digest")
                     if key_name in ref_key})
        log(f"[cli] {stem}: {len(got.proof)}-byte proof, stages "
            f"{json.dumps(prover.LAST_STAGE_TIMES)}; equal to build/{stem}"
            f".proof and build/{stem}.pk.vk: {json.dumps(same, sort_keys=True)}")
        if not all(same.values()):
            raise AssertionError(f"cli: {stem} differs from the committed "
                                 f"artifacts: {same}")

    with environ_set("PARAMS_DIR", params_dir), key_files(card) as keys:
        run("gen-params", ["gen-params", "--k", "17"])
        for stem, signed, issuer in CLI_RSA:
            with open(os.path.join(testdata, issuer), "rb") as f:
                bits = extract_public_key(parse_pem(f.read())).bit_length()
            log(f"[cli] {stem}: {signed} signed by {issuer}, a {bits}-bit "
                f"RSA key")
            pk_path = os.path.join(build, f"{stem}.pk")
            certs = ["--verify-cert-path", os.path.join(testdata, signed),
                     "--issuer-cert-path", os.path.join(testdata, issuer),
                     "--pk-path", pk_path]
            run(f"gen-rsa-keys {stem}", ["gen-rsa-keys"] + certs,
                f"cli_{stem}_keygen")
            keys.reads = keys.keygens = 0
            run(f"prove-rsa {stem}", ["prove-rsa"] + certs + [
                "--proof-path", os.path.join(build, f"{stem}.proof")],
                f"cli_{stem}_proof")
            keys.read_not_made(f"prove-rsa {stem}", pk_path)
            held(stem)
        for stem, pem in CLI_SHA:
            args = ["--cert-path", os.path.join(testdata, pem),
                    "--pk-path", os.path.join(build, f"{stem}.pk")]
            run(f"gen-zkevm-sha256-keys {stem}",
                ["gen-zkevm-sha256-keys"] + args, f"cli_{stem}_keygen")
            keys.reads = keys.keygens = 0
            run(f"prove-zkevm-sha256 {stem}", ["prove-zkevm-sha256"]
                + args + ["--proof-path",
                          os.path.join(build, f"{stem}.proof")],
                f"cli_{stem}_proof")
            keys.read_not_made(f"prove-zkevm-sha256 {stem}", args[-1])
            held(stem)
        # the gate-level SHA-256 of the 970-byte TBS at k=19
        pem = os.path.join(testdata, "example_cert_3.pem")
        pk_path = os.path.join(build, "unoptimized_sha256.pk")
        proof_path = os.path.join(build, "unoptimized_sha256.proof")
        gate = ["--cert-path", pem, "--k", "19", "--pk-path", pk_path]
        run("gen-unoptimized-sha256-keys", ["gen-unoptimized-sha256-keys"]
            + gate, "cli_gate_keygen")
        keys.reads = keys.keygens = 0
        run("prove-unoptimized-sha256", ["prove-unoptimized-sha256"] + gate
            + ["--proof-path", proof_path], "cli_gate_proof")
        keys.read_not_made("prove-unoptimized-sha256", pk_path)
    with open(pem, "rb") as f:
        tbs, _ = extract_tbs_and_sig(parse_pem(f.read()))
    snark = sdk.Snark.read(proof_path)
    log(f"[cli] unoptimized_sha256: {len(snark.proof)}-byte proof, stages "
        f"{json.dumps(prover.LAST_STAGE_TIMES)}")
    check_snark("cli unoptimized_sha256",
                gen_srs(19, params_dir, device), snark,
                snark.instances == [list(hashlib.sha256(tbs).digest())])
    log(f"[cli] subcommands (s, {card}): {json.dumps(seconds)}")
    log(f"[cli] key files ({card}): {json.dumps(keys.files)}")
    return launches


def check_snark(label: str, params, snark, instances_ok: bool = True,
                verify=None) -> None:
    """A snark file's proof verifies (`verify`, by default `verify_snark`)
    and a copy with one byte flipped does not."""
    from halo2_zkcert_tpu_torch import sdk
    verify = verify or (lambda s: sdk.verify_snark(params, s))
    t0 = time.perf_counter()
    ok = verify(snark)
    dt = time.perf_counter() - t0
    bad = bytearray(snark.proof)
    bad[len(bad) // 2] ^= 1
    try:
        rejected = not verify(sdk.Snark(snark.vk, snark.instances,
                                        bytes(bad)))
    except (AssertionError, ValueError):
        rejected = True                           # an undecodable point
    log(f"[verify] {label}: accepts the proof: {ok} ({dt:.3f} s); rejects a "
        f"flipped byte: {rejected}; instances as expected: {instances_ok}")
    if not (ok and rejected and instances_ok):
        raise AssertionError(f"{label}: verifier check failed")


# ---------------------------------------------------------------------------
# phase 13: the four-step transform on the int8 tensor cores
# ---------------------------------------------------------------------------

# the dense int8 rate of one H100 SXM's tensor cores at 700 W (data sheet)
INT8_OPS_PER_S = 1979e12
# a base DFT's epilogue an output element, in 256-bit products (128 word
# products each): two schoolbook products (64 + 16) and one Montgomery
# reduction (64), bn254.cuh dft_words_to_fe
DFT_PRODUCTS = 144 / 128


def _capture_dft_launches(fn) -> list:
    """Run fn() and return the base DFT launches it made: (x, r_log,
    consts, cin, cout), x cloned as it was passed."""
    from halo2_zkcert_tpu_torch.ops import ntt_mxu
    seen, real = [], ntt_mxu.dft_s8

    def spy(x, r_log, consts, cin, cout):
        seen.append((x.clone(), r_log, consts, cin, cout))
        return real(x, r_log, consts, cin, cout)

    ntt_mxu.dft_s8 = spy
    try:
        fn()
    finally:
        ntt_mxu.dft_s8 = real
    return seen


def _dft_record(name, launch) -> dict:
    """One base DFT launch shape: the kernel against its plain version over
    column slices (every column), its device time, the plain version's, and
    torch._int_mm (cuBLASLt s8 x s8 -> s32) on the same product alone as the
    library yardstick (its digits d - 128: the kernel takes the bytes d
    unsigned, a product of the same shape and work).  Besides: the loader
    the launch took (`ntt_mxu.dft_s8_plan`), the int8 rate achieved against
    the whole 64 x 32 blocks and against their band, and the factor to
    torch._int_mm."""
    from halo2_zkcert_tpu_torch.ops import ntt_mxu
    x, r_log, consts, cin, cout = launch
    r = 1 << r_log
    m = x.numel() // 8 // r
    groups = m // cout
    step = max(1, 4096 // cout)

    def plain(g0, g1):
        xs = x.reshape(m // cin, -1)[g0 * cout // cin:g1 * cout // cin]
        return ntt_mxu.dft_s8_plain(xs.reshape(-1, 8), r_log, consts, cin,
                                    cout).reshape(g1 - g0, -1)

    err, plain_ms = _sliced(name, lambda: ntt_mxu.dft_s8(
        x, r_log, consts, cin, cout).reshape(groups, -1),
        lambda g0, g1: plain(g0, min(g1, groups)), groups, step)
    ms = kernel_ms(lambda: ntt_mxu.dft_s8(x, r_log, consts, cin, cout), 5)
    digits = (ntt_mxu._columns(x, r, cin).contiguous().view(torch.uint8)
              .reshape(m, 32 * r) ^ 0x80).view(torch.int8)
    lhs = consts[0]
    library_ms = cuda_ms(lambda: torch._int_mm(lhs, digits.t()), 5)
    # the multiply-adds the function needs: of each (k, j) block of lhs,
    # 64 limbs x 32 digits, only the band of L1 = 33 digits a column is
    # nonzero (the kernel and torch._int_mm multiply the whole block)
    int8_ops = 2 * ntt_mxu.L1 * ntt_mxu.NB * r * r * m
    red_ops = OPS_PER_MUL * DFT_PRODUCTS * r * m
    nbytes = 2 * 32 * r * m + lhs.numel() + 4 * consts[1].numel()
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = max(int8_ops / INT8_OPS_PER_S, red_ops / OPS_PER_S) * 1e3
    rec = _record(name, "halo2_zkcert_tpu_torch/csrc/ntt_mxu.cu",
                  "halo2_zkcert_tpu/ops/ntt_mxu.py:184", err, ms, plain_ms,
                  0, 0, "ntt_mxu")
    plan = ntt_mxu.dft_s8_plan(m, r_log, cin)
    block_ops = 2 * ntt_mxu.LOUT * ntt_mxu.NB * r * r * m
    rec.update(bound_ms=max(b_ms, o_ms),
               bound_by="bytes" if b_ms >= o_ms else "operations",
               library_ms=library_ms, int8_ops=int8_ops,
               loader=plan["loader"],
               block_share=block_ops / (rec["ms"] * 1e-3) / INT8_OPS_PER_S,
               band_share=int8_ops / (rec["ms"] * 1e-3) / INT8_OPS_PER_S,
               library_factor=rec["ms"] / library_ms,
               int8_bound_ms=int8_ops / INT8_OPS_PER_S * 1e3,
               reduction_bound_ms=red_ops / OPS_PER_S * 1e3,
               shape={"radix": r, "columns": m, "cin": cin, "cout": cout})
    return rec


def check_ntt_mxu(device, rng, link) -> tuple:
    """Phase 13.  The four-step at the RSA path's shapes: `intt` over
    (8, 2^17) and `coset_ntt` (8, 2^17 -> 2^19) with Montgomery form out,
    each equal to the radix-2 kernel's transform and timed; every base DFT
    launch they make held against its plain version and timed beside
    torch._int_mm.  Then the RSA k=17 proof with H2T_NTT_MXU=1 (fixed base):
    it must verify, reject a flipped byte and equal build/rsa_1.proof.
    Returns (records, launches of the timed proof)."""
    from halo2_zkcert_tpu_torch.ops import ntt, ntt_mxu
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    g = rc.FR_GENERATOR
    a = random_canonical(rng, 8 << 17, device, FR.modulus).reshape(8, 1 << 17,
                                                                   8)
    recs = []
    for label, mxu, radix2, kk, n_out in (
            ("inverse[8x131072]", lambda: ntt_mxu.intt(a, 17),
             lambda: ntt.intt(a, 17), 17, 1 << 17),
            ("coset.mont[8x131072->524288]",
             lambda: ntt_mxu.coset_ntt(a, 19, g, out_mont=True),
             lambda: ntt.coset_ntt(a, 19, g, out_mont=True), 19, 1 << 19)):
        launches = _capture_dft_launches(mxu)
        ok = torch.equal(mxu(), radix2())
        mxu_ms, mxu_issued = kernel_ms(mxu, 3)
        r2_ms, _ = kernel_ms(radix2, 3)
        # the transform's own bound, as check_ntt gives it to ntt.cu
        bound_ms, bound_by = _bound(32 * 8 * ((1 << 17) + n_out),
                                    OPS_PER_MUL * 8 * n_out * kk // 2)
        log(f"[ntt_mxu] four-step {label}: "
            f"{'equal to' if ok else 'DIFFERENT FROM'} the radix-2 kernel's; "
            f"levels {[l[1] for l in launches]}, {mxu_ms:.4f} ms "
            f"({mxu_issued:.4f} as issued; base DFTs and twiddle products) "
            f"against ntt.cu {r2_ms:.4f} ms; the transform's bound "
            f"{bound_ms:.4f} ms by {bound_by}")
        if not ok:
            raise AssertionError(f"four-step {label} differs from ntt.cu")
        for i, launch in enumerate(launches):
            recs.append(_dft_record(
                f"ntt_mxu.dft[{label} level {i}: r={1 << launch[1]}]", launch))
            torch.cuda.empty_cache()
    del a
    torch.cuda.empty_cache()
    with environ_set("H2T_NTT_MXU", "1"):
        launches = prove(device, "four-step", *link, warmup=True)
    return recs, launches


# ---------------------------------------------------------------------------
# phase 14: the sharded prover over torch.distributed
# ---------------------------------------------------------------------------

SHARDED_SEED = 1414


def _sharded_rank(mesh, params_dir: str, proofs: int) -> dict:
    """One rank of phase 14: the sharded MSM over the k=17 SRS's 2^17
    points and the sharded transform and inverse of (8, 2^17), each against
    the single-device call; then `proofs` RSA k=17 proofs under
    `prover_mesh`, the traffic, transforms and launches of the last.  Runs
    in a spawned process."""
    from halo2_zkcert_tpu_torch.bench import load_rsa_link, prove_rsa
    from halo2_zkcert_tpu_torch.ops import kernels, msm, ntt
    from halo2_zkcert_tpu_torch.ops.field import FR
    from halo2_zkcert_tpu_torch.parallel import (msm_sharded_affine,
                                                 ntt_sharded, prover_mesh)
    from halo2_zkcert_tpu_torch.parallel.ntt_sharded import counts
    from halo2_zkcert_tpu_torch.plonk import kzg
    dev, out = mesh.device, {"rank": mesh.rank, "backend": mesh.backend,
                             "staged": mesh.staged}
    params = kzg.ParamsKZG.read(os.path.join(params_dir, "kzg_bn254_17.srs"),
                                dev)
    rng = np.random.default_rng(SHARDED_SEED)
    sc = random_canonical(rng, 1 << 17, dev, FR.modulus)
    got = msm_sharded_affine(params.g, sc, mesh)
    out["msm_equal"] = torch.equal(got, msm.msm(params.g, sc))
    a = random_canonical(rng, 8 << 17, dev, FR.modulus).reshape(8, 1 << 17, 8)
    m = (1 << 17) // mesh.size
    rows = slice(mesh.rank * m, (mesh.rank + 1) * m)
    block = a[:, rows].contiguous()
    out["ntt_equal"] = torch.equal(ntt_sharded(block, 17, mesh),
                                   ntt.ntt(a, 17)[:, rows])
    out["intt_equal"] = torch.equal(ntt_sharded(block, 17, mesh, True),
                                    ntt.intt(a, 17)[:, rows])
    torch.cuda.synchronize(dev)
    out["checks_bytes"], out["checks_seconds"] = mesh.bytes_sent, mesh.seconds
    if proofs:
        link = load_rsa_link(dev)
        out["proofs"], out["seconds"] = [], []
        for _ in range(proofs):
            mesh.bytes_sent, mesh.seconds, mesh.collectives = 0, 0.0, 0
            counts.clear()
            kernels.reset_launches()
            with prover_mesh(mesh):
                proof, instances, dt = prove_rsa(params, *link, dev)
            out["proofs"].append((proof, instances))
            out["seconds"].append(dt)
        out.update(launches=dict(kernels.launches), counts=dict(counts),
                   bytes=mesh.bytes_sent, comm_seconds=mesh.seconds,
                   collectives=mesh.collectives,
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    return out


def _report_sharded(label: str, res: list) -> None:
    """Log each rank of a phase 14 run; fail unless its checks hold and
    every proof equals build/rsa_1.proof with no scan_madd launch."""
    from halo2_zkcert_tpu_torch.sdk import Snark
    ref = Snark.read(os.path.join(REPO, "build", "rsa_1.proof"))
    bad = []
    for out in res:
        checks = (out["msm_equal"], out["ntt_equal"], out["intt_equal"])
        line = (f"[sharded] {label} rank {out['rank']} "
                f"({out['backend']}, staged through the host: "
                f"{out['staged']}): msm, ntt, intt equal to one device: "
                f"{checks}; their collectives {out['checks_bytes']} "
                f"bytes sent in {out['checks_seconds']:.3f} s")
        if not all(checks):
            bad.append(f"rank {out['rank']} checks")
        if "proofs" in out:
            same = all(p == (ref.proof, ref.instances) for p in out["proofs"])
            line += (f"; proofs {[round(t, 4) for t in out['seconds']]} s, "
                     f"{'equal to' if same else 'DIFFERENT FROM'} "
                     f"build/rsa_1.proof; the last: collectives "
                     f"{out['collectives']}, {out['bytes']} bytes sent in "
                     f"{out['comm_seconds']:.3f} s; transforms "
                     f"{json.dumps(out['counts'], sort_keys=True)}; "
                     f"peak {out['peak_gb']:.2f} GB; launches "
                     f"{json.dumps(out['launches'], sort_keys=True)}")
            if not same:
                bad.append(f"rank {out['rank']} proof")
            if out["launches"].get("scan_madd", 0):
                bad.append(f"rank {out['rank']} launched scan_madd")
        log(line)
    if bad:
        raise AssertionError(f"sharded {label}: {bad}")


def check_card_a_rank(card: str, params_dir: str, cards: int,
                      repeat: int = 3) -> None:
    """`cards` `nccl` ranks, one card each: the sharded checks and a warm-up
    and `repeat` RSA k=17 proofs on every rank, beside as many proofs on
    cuda:0 alone on the variable base (the commitment path a mesh takes);
    every proof equal to build/rsa_1.proof.  Needs the kernels built and
    the k=17 SRS in params_dir (phase 2 writes it)."""
    from halo2_zkcert_tpu_torch.bench import load_rsa_link, prove_rsa
    from halo2_zkcert_tpu_torch.parallel.mesh import run_ranks
    from halo2_zkcert_tpu_torch.plonk import kzg
    from halo2_zkcert_tpu_torch.sdk import Snark
    ref = Snark.read(os.path.join(REPO, "build", "rsa_1.proof"))
    device = torch.device("cuda", 0)
    params = kzg.ParamsKZG.read(os.path.join(params_dir, "kzg_bn254_17.srs"),
                                device)
    link = load_rsa_link(device)
    one = []
    with environ_set("H2T_FB_MSM", "0"):
        for _ in range(repeat + 1):
            proof, instances, dt = prove_rsa(params, *link, device)
            if (proof, instances) != (ref.proof, ref.instances):
                raise AssertionError("one card's variable-base proof differs "
                                     "from build/rsa_1.proof")
            one.append(dt)
    del params, link
    torch.cuda.empty_cache()
    label = f"nccl x{cards}, a card a rank"
    res = run_ranks(_sharded_rank, cards, "nccl",
                    [f"cuda:{i}" for i in range(cards)],
                    args=(params_dir, repeat + 1))
    _report_sharded(label, res)
    medians = [statistics.median(out["seconds"][1:]) for out in res]
    log(f"[sharded] {label}: median of {repeat} warm proofs a rank "
        f"{[round(t, 4) for t in medians]} s, bytes sent a rank in the last "
        f"{[out['bytes'] for out in res]}; cuda:0 alone, variable base: "
        f"{[round(t, 4) for t in one[1:]]} s, median "
        f"{statistics.median(one[1:]):.4f} s; {card}")


def check_sharded(card: str, params_dir: str) -> dict:
    """Phase 14.  Four `gloo` ranks sharing cuda:0 (NCCL refuses two ranks
    on one device; the mesh stages its collectives through CPU tensors):
    the sharded MSM and transforms, and the RSA k=17 proof under
    `prover_mesh`, equal to build/rsa_1.proof on every rank with no
    scan_madd launch.  Then a one-rank `nccl` group through the same
    sharded calls, and, where the machine has two cards or more,
    `check_card_a_rank` over up to 4.  Returns the launches of rank 0's
    proof."""
    from halo2_zkcert_tpu_torch.parallel.mesh import run_ranks
    t0 = time.perf_counter()
    res = run_ranks(_sharded_rank, 4, "gloo", ["cuda:0"] * 4,
                    args=(params_dir, 1))
    log(f"[sharded] 4 gloo ranks on cuda:0: {time.perf_counter() - t0:.3f} s "
        f"with spawning; {card}")
    _report_sharded("gloo x4 on one card", res)
    t0 = time.perf_counter()
    _report_sharded("nccl x1", run_ranks(_sharded_rank, 1, "nccl", ["cuda:0"],
                                         args=(params_dir, 0)))
    log(f"[sharded] one nccl rank: {time.perf_counter() - t0:.3f} s")
    cards = min(torch.cuda.device_count(), 4)
    if cards >= 2:
        check_card_a_rank(card, params_dir, cards)
    else:
        log(f"[sharded] {torch.cuda.device_count()} card: no nccl proof with "
            f"a card a rank")
    return res[0]["launches"]


# ---------------------------------------------------------------------------
# phase 15: the prover's debugging knobs
# ---------------------------------------------------------------------------

# (knob, value) of each RSA k=17 proof phase 15 makes
KNOB_PROOFS = (("H2T_SELFCHECK", "1"), ("H2T_SELFCHECK", "2"),
               ("H2T_SELFCHECK", "3"), ("H2T_SELFCHECK", "4"),
               ("H2T_EVAL_MODE", "coeff"))
# the knob proofs whose launch counts are kept, and their paths' names
KNOB_PATHS = {("H2T_SELFCHECK", "3"): "selfcheck3_proof",
              ("H2T_EVAL_MODE", "coeff"): "eval_coeff_proof"}
Z_ROW = 5          # a row of the first permutation Z before u_row
K4_ROW = 20        # an extended row inside the level-4 window [17, 25)


def selfcheck_labels(knob, cs) -> set:
    """The verdicts a proof of constraint system `cs` must report under
    `knob` (name, value): level 1's identity at x, level 2's host
    evaluations, level 3's recurrence of every Z, level 4's and 5's window;
    none for the other knobs."""
    level = knob[1] if knob[0] == "H2T_SELFCHECK" else None
    if not level:
        return set()
    labels = {"quotient identity"}
    if level == "2":
        labels |= {"bary(advice0, x)", "bary(sigma0, x)", "bary(h, x)",
                   "horner(h_collapsed, x)"}
    if level == "3":
        chunks = cs.num_permutation_chunks()
        labels |= {f"perm_z{c} recurrence" for c in range(chunks)}
        labels |= {f"perm_z{c} chain start" for c in range(1, chunks)}
        labels |= {"perm_z last == 1 at u_row"} if chunks else set()
        labels |= {f"lookup{i}_z recurrence" for i in range(len(cs.lookups))}
    if level in ("4", "5"):
        labels.add("quotient window")
    return labels


def knob_proof(knob, fn) -> tuple:
    """fn() with the environment's `knob` (name, value) set: its result,
    wall seconds, the launch counts and the prover's self-check verdicts."""
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import prover
    kernels.reset_launches()
    with environ_set(*knob):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return out, dt, dict(kernels.launches), dict(prover.LAST_SELFCHECK)


class corrupted:
    """A fault patched into plonk/prover.py for the block: "z" adds one to
    row Z_ROW of the first permutation Z before its commitment (around
    `_grand_products`), "k4" adds one to row K4_ROW of K4's output (around
    `quotient_forest`)."""

    def __init__(self, what: str):
        self.what = what

    def __enter__(self):
        from halo2_zkcert_tpu_torch.ops import field
        from halo2_zkcert_tpu_torch.ops.field import FR
        from halo2_zkcert_tpu_torch.plonk import prover
        name = {"z": "_grand_products", "k4": "quotient_forest"}[self.what]
        real = getattr(prover, name)

        def bump(t, row):
            t = t.clone()
            t[row] = field.add(FR, t[row], field.one(t.device))
            return t

        def hooked(*args, **kwargs):
            out = real(*args, **kwargs)
            if self.what == "k4":
                return bump(out, K4_ROW)
            zs, num, den = out
            return [bump(zs[0], Z_ROW)] + zs[1:], num, den

        self.saved = (prover, name, real)
        setattr(prover, name, hooked)

    def __exit__(self, *exc):
        setattr(*self.saved)


def check_knobs(device, link, card: str) -> dict:
    """Phase 15: the RSA k=17 proof on the fixed base under each of
    KNOB_PROOFS equals build/rsa_1.proof with every self-check verdict OK
    (level 3's residuals on K1, level 4's window an exact oracle of K4,
    coefficient-form evaluations through ntt.cu); then three runs with a
    fault patched in (`corrupted`): a Z value at level 1 (the identity at
    x: MISMATCH) and at level 3 (the recurrence: VIOLATED), K4's output at
    level 4 (the window: MISMATCH).  Returns the launch counts of the
    level-3 and the coefficient-form proofs."""
    from halo2_zkcert_tpu_torch.bench import prove_rsa
    from halo2_zkcert_tpu_torch.sdk import Snark
    ref = Snark.read(os.path.join(REPO, "build", "rsa_1.proof"))
    params, circuit, pk, sig, digest = link

    def rsa_proof():
        return prove_rsa(params, circuit, pk, sig, digest, device)[0]

    launches = {}
    for knob in KNOB_PROOFS:
        proof, dt, counts, verdicts = knob_proof(knob, rsa_proof)
        same = proof == ref.proof
        ok = verdicts == dict.fromkeys(selfcheck_labels(knob, pk.vk.cs),
                                       "OK")
        log(f"[knobs] {knob[0]}={knob[1]}: proof {dt:.3f} s "
            f"(checks included), {'equal to' if same else 'DIFFERENT FROM'} "
            f"build/rsa_1.proof; verdicts {json.dumps(verdicts)} ({card})")
        if not (same and ok):
            raise AssertionError(f"knobs: {knob}: bytes equal {same}, "
                                 f"verdicts {verdicts}")
        if knob in KNOB_PATHS:
            launches[KNOB_PATHS[knob]] = counts
    for what, level, want in (
            ("z", "1", {"quotient identity": "MISMATCH"}),
            ("z", "3", {"perm_z0 recurrence": "VIOLATED",
                        "quotient identity": "MISMATCH"}),
            ("k4", "4", {"quotient window": "MISMATCH"})):
        with corrupted(what):
            _, _, _, verdicts = knob_proof(("H2T_SELFCHECK", level), rsa_proof)
        wrong = {k: v for k, v in verdicts.items() if v != want.get(k, "OK")
                 and not (what == "k4" and k == "quotient identity")}
        fault = {"z": "a Z value", "k4": "K4's output"}[what]
        log(f"[knobs] a fault in {fault} at level {level}: verdicts "
            f"{json.dumps(verdicts)}")
        labels = selfcheck_labels(("H2T_SELFCHECK", level), pk.vk.cs)
        if wrong or not set(want) <= labels or set(verdicts) != labels:
            raise AssertionError(f"knobs: fault {what} at level {level}: "
                                 f"{verdicts}, wanted {want}")
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
    gate = [launches[f"{p}_proof"] for p in ("builder_sample",
                                             "sha256_gate_short",
                                             "sha256_gate_cli")]
    cli = launches["sha256_gate_cli_proof"]
    agg, agg_key = launches["x509_agg_proof"], launches["x509_agg_keygen"]
    agg_setup = launches["x509_agg_setup"]
    mocks = [launches[f"{p}_mock"] for p in ("builder_sample",
                                             "sha256_gate_cli", "x509_agg")]
    agg_evm = launches["x509_agg_evm_proof"]
    cli_rsa = [launches[f"cli_rsa_{i}_proof"] for i in (1, 2)]
    cli_sha = [launches[f"cli_sha256_{i}_proof"] for i in (1, 2)]
    acc = [launches[f"acc_toy_{w}_proof"] for w in ("good", "bad")]

    def like_fixed_base(p, windows):
        """What the fixed-base RSA proof launches, as the first proof with
        its key (read from the key file): up to 8 more ntt launches, which
        put the key's columns on the extended domain (plonk/prover.py
        `_Quotient`, built once a key); `windows` point_windows launches
        allowed (a window table built at its first use)."""
        points = sum(p.get(k, 0) for k in ("point_add", "point_scan",
                                           "point_row_sum"))
        binop = sum(v for k, v in p.items() if k.startswith("field_binop."))
        return (p.get("quotient_forest", 0) == 1 and p.get("scan_madd", 0)
                and points < 100 and binop < 300
                and 0 < p.get("ntt", 0) <= 16
                and p.get("point_windows", 0) <= windows
                and not any(p.get(k, 0) for k in chains
                            if k != "point_windows"))

    mxu, sharded = launches["ntt_mxu_proof"], launches["sharded_proof"]
    sc3, coeff = launches["selfcheck3_proof"], launches["eval_coeff_proof"]
    gate_key, gate_cli = launches["cli_gate_keygen"], launches["cli_gate_proof"]

    def chains_but_windows(p, windows, fixed_mul=0):
        """No chain kernel but up to `windows` point_windows (a window
        table built at its first use) and `fixed_mul` point_fixed_mul (an
        SRS set up)."""
        return (p.get("point_windows", 0) <= windows
                and p.get("point_fixed_mul", 0) <= fixed_mul
                and not any(p.get(k, 0) for k in chains
                            if k not in ("point_windows", "point_fixed_mul")))

    rules = (
        ("H2T_SELFCHECK=3's proof: more field_binop.sub and .mul than the "
         "fixed-base proof (the recurrences' residuals on K1)",
         sc3.get("field_binop.sub", 0) > fb.get("field_binop.sub", 0)
         and sc3.get("field_binop.mul", 0) > fb.get("field_binop.mul", 0)),
        ("H2T_EVAL_MODE=coeff's proof: more ntt launches than the fixed-base "
         "proof (the queried columns' inverse transform)",
         coeff.get("ntt", 0) > fb.get("ntt", 0)),
        ("gen-unoptimized-sha256-keys (k=19): field_binop.mul, ntt, "
         "scan_madd; at most one point_fixed_mul (the SRS) and 4 "
         "point_windows (the Lagrange table), no other chain kernel",
         gate_key.get("field_binop.mul", 0) and gate_key.get("ntt", 0)
         and gate_key.get("scan_madd", 0)
         and chains_but_windows(gate_key, 4, 1)),
        ("prove-unoptimized-sha256 (k=19): one quotient_forest, ntt, "
         "scan_madd, field_scan; at most 4 point_windows (the monomial "
         "table), no other chain kernel",
         gate_cli.get("quotient_forest", 0) == 1 and gate_cli.get("ntt", 0)
         and gate_cli.get("scan_madd", 0) and gate_cli.get("field_scan", 0)
         and chains_but_windows(gate_cli, 4)),
        ("the four-step proof (H2T_NTT_MXU=1): ntt_mxu, no ntt, one "
         "quotient_forest",
         mxu.get("ntt_mxu", 0) > 0 and mxu.get("ntt", 0) == 0
         and mxu.get("quotient_forest", 0) == 1),
        ("the sharded proof (rank 0 of 4): no scan_madd, point_scan_affine "
         "(the variable base), ntt, one quotient_forest, no ntt_mxu",
         not sharded.get("scan_madd", 0)
         and sharded.get("point_scan_affine", 0) > 0
         and sharded.get("ntt", 0) > 0
         and sharded.get("quotient_forest", 0) == 1
         and not sharded.get("ntt_mxu", 0)),
        ("the k=20 aggregation's Keccak proof (gen-x509-agg-evm-proof's "
         "step, both tables read from the cache): one quotient_forest, ntt, "
         "scan_madd, field_scan, field_row_sum, point_scan, point_row_sum, "
         "no chain kernel",
         agg_evm.get("quotient_forest", 0) == 1 and agg_evm.get("ntt", 0)
         and agg_evm.get("scan_madd", 0) and agg_evm.get("field_scan", 0)
         and agg_evm.get("field_row_sum", 0) and agg_evm.get("point_scan", 0)
         and agg_evm.get("point_row_sum", 0)
         and not any(agg_evm.get(k, 0) for k in chains)),
        ("the CLI's 4096-bit RSA proof (prove-rsa rsa_2): what the fixed-base "
         "proof launches, no chain kernel (both tables read from the cache)",
         like_fixed_base(cli_rsa[1], 0)),
        ("the CLI's first RSA proof (prove-rsa rsa_1): what the fixed-base "
         "proof launches, and at most one point_windows (the monomial "
         "basis's table, built at its first use) of the chain kernels",
         like_fixed_base(cli_rsa[0], 1)),
        ("each CLI SHA-256 proof: one quotient_forest, scan_madd, ntt, no "
         "point_double",
         all(p.get("quotient_forest", 0) == 1 and p.get("scan_madd", 0)
             and p.get("ntt", 0) and not p.get("point_double", 0)
             for p in cli_sha)),
        ("each accumulator toy proof: one quotient_forest, no point_double",
         all(p.get("quotient_forest", 0) == 1 and not p.get("point_double", 0)
             for p in acc)),
        ("each gate-level proof: one quotient_forest, no point_double",
         all(p.get("quotient_forest", 0) == 1 and not p.get("point_double", 0)
             for p in gate)),
        ("the k=19 gate-level proof: ntt, scan_madd, field_scan",
         cli.get("ntt", 0) and cli.get("scan_madd", 0)
         and cli.get("field_scan", 0)),
        ("the k=20 aggregation proof (gen-x509-agg-proof's step): one "
         "quotient_forest, ntt, scan_madd, field_scan, field_row_sum, "
         "point_scan, point_row_sum; at most 8 point_windows (the monomial "
         "table), no other chain kernel",
         agg.get("quotient_forest", 0) == 1 and agg.get("ntt", 0)
         and agg.get("scan_madd", 0) and agg.get("field_scan", 0)
         and agg.get("field_row_sum", 0) and agg.get("point_scan", 0)
         and agg.get("point_row_sum", 0) and chains_but_windows(agg, 8)),
        ("the k=20 aggregation keygen (gen-x509-agg-keys): field_binop.mul "
         "(sigma), ntt, scan_madd; at most one point_fixed_mul (the SRS) "
         "and 8 point_windows (the Lagrange table), no other chain kernel",
         agg_key.get("field_binop.mul", 0) and agg_key.get("ntt", 0)
         and agg_key.get("scan_madd", 0)
         and chains_but_windows(agg_key, 8, 1)),
        ("the k=20 SRS and tables: point_fixed_mul, 16 point_windows "
         "(2^17-point slices of both bases; one more where G's table is "
         "not yet cached), no point_double",
         agg_setup.get("point_fixed_mul", 0)
         and agg_setup.get("point_windows", 0) in (16, 17)
         and not agg_setup.get("point_double", 0)),
        ("MockProver on the card: its gates through field_binop",
         all(m.get("field_binop.mul", 0) and m.get("field_binop.add", 0)
             for m in mocks)),
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


def log_gmma_sass(kernels) -> None:
    """The count of tensor-core warpgroup instructions (IGMMA, HGMMA) in
    k_dft_s8's SASS, where the toolkit has cuobjdump: the product runs on
    wgmma, not mma.sync."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if not os.path.exists(tool):
        log("[build] k_dft_s8 SASS: no cuobjdump in the toolkit")
        return
    sass = subprocess.run([tool, "-sass", str(kernels._lib_path("ntt_mxu"))],
                          capture_output=True, text=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "k_dft_s8" in fn:
            for op in ("IGMMA", "HGMMA", "IMMA"):
                if op in line:
                    counts[op] = counts.get(op, 0) + 1
    log(f"[build] k_dft_s8 SASS: {counts} (cuobjdump)")
    if not counts.get("IGMMA"):
        raise AssertionError("k_dft_s8: no IGMMA in its SASS, the product "
                             "is not on wgmma")


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

    from halo2_zkcert_tpu_torch import native
    build_s = kernels.build_all(verbose=True)
    log_gmma_sass(kernels)
    t0 = time.perf_counter()
    host_lib = native.build()
    card = card_line()
    log(f"[build] kernels built in {build_s:.3f} s; host library "
        f"{os.path.basename(host_lib)} (g++) in "
        f"{time.perf_counter() - t0:.3f} s")
    check_native(args.seed, card)
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
    from halo2_zkcert_tpu_torch.sdk import read_vk
    for vk_file, rec_name, rec_path in (
            ("rsa_1.pk.vk", "quotient_forest", None),
            ("sha256_1.pk.vk", "quotient_forest[sha256 tape]",
             "sha256_1_proof")):
        vk = read_vk(os.path.join(REPO, "build", vk_file))
        recs.append(check_quotient(device, vk.cs, vk.k, rng, rec_name,
                                   rec_path))
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
    with environ_set("H2T_FB_MSM", "0"):
        launches["variable_base_proof"] = prove(device, "variable base",
                                                *link, warmup=False)
    mxu_recs, launches["ntt_mxu_proof"] = check_ntt_mxu(device, rng, link)
    recs += mxu_recs
    from halo2_zkcert_tpu_torch.ops import ntt_mxu
    for r in mxu_recs:
        shape = r["shape"]
        plan = ntt_mxu.dft_s8_plan(shape["columns"],
                                   shape["radix"].bit_length() - 1,
                                   shape["cin"])
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms ({r['issued_ms']:.4f} "
            f"as issued from Python, plain {r['plain_ms']:.3f} ms, "
            f"torch._int_mm {r['library_ms']:.4f} ms, {r['library_factor']:.3f}"
            f" times its time; bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}: int8 {r['int8_bound_ms']:.4f}, reduction "
            f"{r['reduction_bound_ms']:.4f}; int8 rate {r['block_share']:.4f} "
            f"of 1979 T/s against the whole blocks, {r['band_share']:.4f} "
            f"against the band; loader {r['loader']}, {plan['tiles']} tiles "
            f"on {plan['blocks']} blocks, planned L2 -> SM "
            f"{plan['l2_bytes'] / 1e9:.3f} GB (the boxes' bytes from the tile "
            f"shape, not measured); {card})")
    launches.update(check_knobs(device, link, card))
    torch.cuda.empty_cache()
    launches["sharded_proof"] = check_sharded(card, params_dir)
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
    del params12
    torch.cuda.empty_cache()

    launches.update(builder_sample(device, card))
    gate_launches, gate_cs = sha256_gate_short(device, card)
    launches.update(gate_launches)
    rec = check_quotient(device, gate_cs, 19, rng,
                         "quotient_forest[sha256_gate tape]",
                         "sha256_gate_cli_proof")
    recs.append(rec)
    torch.cuda.empty_cache()
    launches.update(sha256_gate_cli(device, card))
    # after the path, so that its transforms' tables are built on it
    torch.cuda.empty_cache()
    recs += check_gate_shapes(device, rng)
    # the reference CLI's chain, then the k=20 aggregation over its snark
    # files with its EVM flow, then the kernels at the aggregation's shapes
    del gate_cs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cli_chain_",
                                     dir=os.path.join(REPO, "build")) as work:
        launches.update(cli_chain(device, card, work))
        torch.cuda.empty_cache()
        launches.update(x509_agg(device, card, os.path.join(work, "build"),
                                 work))
    torch.cuda.empty_cache()
    recs += check_agg_shapes(device, rng)
    launches.update(toy_accumulator(device, card))
    for r in recs[recs.index(rec):]:
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms "
            f"({r['issued_ms']:.4f} as issued from Python, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; {card})")

    paths = ("fixed_base_proof", "variable_base_proof", "ntt_mxu_proof",
             "sharded_proof", "ragged_msm",
             "table_build", "srs_setup", "keygen_rsa", "sha256_setup",
             "sha256_1_keygen", "sha256_1_proof", "sha256_2_keygen",
             "sha256_2_proof", "builder_sample_keygen",
             "builder_sample_proof", "builder_sample_mock",
             "sha256_gate_setup", "sha256_gate_short_keygen",
             "sha256_gate_short_proof", "sha256_gate_cli_setup",
             "sha256_gate_cli_keygen", "sha256_gate_cli_mock",
             "sha256_gate_cli_proof", "cli_rsa_1_keygen", "cli_rsa_1_proof",
             "cli_rsa_2_keygen", "cli_rsa_2_proof", "cli_sha256_1_keygen",
             "cli_sha256_1_proof", "cli_sha256_2_keygen",
             "cli_sha256_2_proof", "cli_gate_keygen", "cli_gate_proof",
             "selfcheck3_proof", "eval_coeff_proof",
             "x509_agg_setup", "x509_agg_keygen",
             "x509_agg_mock", "x509_agg_proof", "x509_agg_evm_proof",
             "acc_toy_good_proof", "acc_toy_bad_proof")
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
