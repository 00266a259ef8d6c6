"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each printing its own line:
  1. build the hand-written kernels (csrc/*.cu, one nvcc per source, in
     parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path (exact equality), and time both;
  3. build the k=17 SRS on the card from the default tau and the fixed-base
     window tables of both bases; commit the committed RSA proving key's 12
     fixed and 3 sigma columns through the variable-base and through the
     fixed-base MSM: both must equal the commitments of build/rsa_1.pk.vk;
     then a fixed-base MSM over 5001 points (a pair count that is not whole
     scan rows, the path of the mixed-add kernel) against the variable-base
     MSM of the same points and scalars;
  4. prove the RSA-2048 k=17 link as the port's bench does, on the fixed
     base (the default: a warm-up proof, then a timed one) and once with the
     variable base forced; each proof must verify, a tampered copy must be
     rejected, and the bytes must equal build/rsa_1.proof;
  5. the kernels' launch counts on each driven path: every kernel must have
     been launched on one of them.

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

def _record(name, source, replaces, err, ms, plain_ms, bytes_moved, ops):
    bound_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_o = ops / OPS_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "library_ms": None}


def check_field(device, n: int, rng) -> list:
    from halo2_zkcert_tpu_torch.ops import field
    from halo2_zkcert_tpu_torch.ops.field import FQ, FR
    recs = []
    replaces = {"mul": "halo2_zkcert_tpu/ops/pallas_limbs.py:435",
                "add": "halo2_zkcert_tpu/ops/pallas_limbs.py:441",
                "sub": "halo2_zkcert_tpu/ops/pallas_limbs.py:446"}
    for F in (FR, FQ):
        a = random_canonical(rng, n, device, F.modulus)
        b = random_canonical(rng, n, device, F.modulus).flip(0).contiguous()
        for op in ("mul", "add", "sub"):
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
            ms = cuda_ms(lambda: field.binop(F, op, a, b), 20)
            plain_ms = cuda_ms(lambda: field.binop_plain(F, op, a, b), 2, 1)
            recs.append(_record(
                f"field_binop.{op}", "halo2_zkcert_tpu_torch/csrc/field_binop.cu",
                replaces[op], err, ms, plain_ms, 3 * 32 * n,
                OPS_PER_MUL * n if op == "mul" else 0))
    return recs


def sample_points(device, n: int, rng) -> torch.Tensor:
    """(n, 3, 8) projective points of G1: 64 host multiples of G, each row
    scaled by its own random Z, with the identity and a few P, -P pairs."""
    from halo2_zkcert_tpu_torch.ops import curve, field
    from halo2_zkcert_tpu_torch.ops.field import FQ
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    G = rc.g1_from_affine(rc.G1_GEN)
    base = [rc.g1_to_affine(rc.g1_mul(G, int(s)))
            for s in rng.integers(1, 1 << 62, size=64)]
    aff = curve.points_to_device(base, device)
    P = curve.from_affine(aff[torch.from_numpy(rng.integers(0, 64, size=n))
                              .to(device)])
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
                            replaces, err, cuda_ms(kern, 20),
                            cuda_ms(plain, 2, 1), bytes_per * n,
                            muls * OPS_PER_MUL * n))
    return recs


def check_mixed(device, n: int, rows: int, rng) -> list:
    """K5 at n points and K6 at `rows` rows of SCAN_C points (one full
    column's pairs), table-like affine operands."""
    from halo2_zkcert_tpu_torch.ops import curve, msm_fb
    from halo2_zkcert_tpu_torch.utils import refcrypto as rc
    G = rc.g1_from_affine(rc.G1_GEN)
    aff = curve.points_to_device(
        [rc.g1_to_affine(rc.g1_mul(G, int(s)))
         for s in rng.integers(1, 1 << 62, size=64)], device)

    def pick(*shape):
        return aff[torch.from_numpy(rng.integers(0, 64, size=shape))
                   .to(device)].contiguous()

    P, Q = sample_points(device, n, rng), pick(n)
    P[1:4] = curve.from_affine(Q[1:4])            # P + P
    P[4:8] = curve.neg(curve.from_affine(Q[4:8]))  # (-Q) + Q
    C = msm_fb.SCAN_C
    xy = pick(rows, C)
    xy[1] = xy[1, :1]                             # a row that keeps doubling
    src = "halo2_zkcert_tpu_torch/csrc/"
    cases = (
        ("point_add_mixed", lambda: curve.add_mixed(P, Q),
         lambda: curve.add_mixed_plain(P, Q), src + "point_ops.cu",
         "halo2_zkcert_tpu/ops/pallas_limbs.py:393", n, 8 * 32),
        ("scan_madd", lambda: msm_fb.scan_madd(xy),
         lambda: msm_fb.scan_madd_plain(xy), src + "scan_madd.cu",
         "halo2_zkcert_tpu/ops/pallas_limbs.py:533", rows * C, 5 * 32),
    )
    recs = []
    for name, kern, plain, source, replaces, pairs, bytes_per in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ok = torch.equal(got, want)
        log(f"[kernels] {name} pairs={pairs}: {'exact' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        recs.append(_record(name, source, replaces, err, cuda_ms(kern, 10),
                            cuda_ms(plain, 1, 1), bytes_per * pairs,
                            11 * OPS_PER_MUL * pairs))
    return recs


def check_quotient(device, vk_path: str, rng) -> dict:
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
    consts = tape.const_table(chal)
    got = quotient.quotient_forest(leaves, consts, tape)
    want = quotient.quotient_forest_plain(leaves, consts, tape)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ok = torch.equal(got, want)
    nmul = int((tape.ins[:, 0] == quotient.MUL).sum())
    log(f"[kernels] quotient_forest ext_n={ext_n} leaves={L} "
        f"tape={len(tape.ins)} muls={nmul} slots={tape.num_slots}: "
        f"{'exact' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("quotient_forest disagrees with its plain version")
    return _record(
        "quotient_forest", "halo2_zkcert_tpu_torch/csrc/quotient_forest.cu",
        "halo2_zkcert_tpu/plonk/quotient_pallas.py:315", err,
        cuda_ms(lambda: quotient.quotient_forest(leaves, consts, tape), 10),
        cuda_ms(lambda: quotient.quotient_forest_plain(leaves, consts, tape),
                1, 1),
        (L + 1) * ext_n * 32 + consts.numel() * 4,
        nmul * OPS_PER_MUL * ext_n)


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
    t0 = time.perf_counter()
    params = kzg.setup(17, device=device)
    torch.cuda.synchronize()
    t_srs = time.perf_counter() - t0
    os.makedirs(params_dir, exist_ok=True)
    params.write(os.path.join(params_dir, "kzg_bn254_17.srs"))
    log(f"[srs] k=17 built on the card in {t_srs:.3f} s")
    kernels.reset_launches()
    t0 = time.perf_counter()
    for lagrange in (True, False):
        params.fixed_base(lagrange)
    torch.cuda.synchronize()
    tab = params.fixed_base(True).table_flat
    log(f"[tables] fixed-base window tables of both bases built in "
        f"{time.perf_counter() - t0:.3f} s ({tab.shape[0]} points, "
        f"{tab.numel() * 4 / 1e6:.1f} MB a basis)")
    launches = {"table_build": dict(kernels.launches)}
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
    assert fb.nwin * n % msm_fb.SCAN_C, "pair count must be ragged"
    kernels.reset_launches()
    got = curve.to_affine(fb.msm_many(cols))
    launches = dict(kernels.launches)
    want = curve.to_affine(msm.msm_many(base, cols))
    ok = torch.equal(got, want)
    log(f"[ragged] fixed-base MSM over {n} points ({fb.nwin * n} pairs, "
        f"{launches.get('point_add_mixed', 0)} point_add_mixed launches): "
        f"{'equal to' if ok else 'DIFFERENT FROM'} the variable-base MSM")
    if not ok:
        raise AssertionError("ragged fixed-base MSM differs")
    return launches


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
    return launches


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
    recs += check_points(device, 1 << 17, rng)
    recs += check_mixed(device, 1 << 17, 1 << 15, rng)
    recs.append(check_quotient(
        device, os.path.join(REPO, "build", "rsa_1.pk.vk"), rng))
    for r in recs:
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms (plain "
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
    paths = ("fixed_base_proof", "variable_base_proof", "ragged_msm")
    for path in paths + ("table_build",):
        log(f"[launches] {path}: "
            f"{json.dumps(launches[path], sort_keys=True)}")
    for r in recs:
        r["launches_by_path"] = {p: launches[p].get(r["name"], 0)
                                 for p in paths}
        r["launches_path"] = next(
            (p for p in paths if r["launches_by_path"][p] > 0), None)
        r["launches"] = r["launches_by_path"].get(r["launches_path"], 0)
    missing = [r["name"] for r in recs if r["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels launched on no driven path: {missing}")

    print(card, flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
