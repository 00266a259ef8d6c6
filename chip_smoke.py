"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each printing its own line:
  1. build the hand-written kernels (csrc/*.cu, one nvcc per source, in
     parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path (exact equality), and time both;
  3. build the k=17 SRS on the card from the default tau, and commit the
     committed RSA proving key's 12 fixed and 3 sigma columns: they must
     equal the commitments of build/rsa_1.pk.vk;
  4. prove the RSA-2048 k=17 link as the port's bench does (a warm-up
     proof, then a timed one), verify it, and reject a tampered copy;
  5. the kernels' launch counts on the timed proof: each must be > 0.

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

def check_srs(device, params_dir: str):
    from halo2_zkcert_tpu_torch.bench import load_rsa_link
    from halo2_zkcert_tpu_torch.plonk import kzg
    t0 = time.perf_counter()
    params = kzg.setup(17, device=device)
    torch.cuda.synchronize()
    t_srs = time.perf_counter() - t0
    os.makedirs(params_dir, exist_ok=True)
    params.write(os.path.join(params_dir, "kzg_bn254_17.srs"))
    circuit, pk, sig, digest = load_rsa_link(device)
    t0 = time.perf_counter()
    fixed = kzg.commit_many_lagrange(params, pk.fixed_lagrange)
    sigma = kzg.commit_many_lagrange(params, pk.sigma_lagrange)
    t_commit = time.perf_counter() - t0
    ok_f = fixed == pk.vk.fixed_commitments
    ok_s = sigma == pk.vk.permutation_commitments
    log(f"[srs] k=17 built on the card in {t_srs:.3f} s; {len(fixed)} fixed "
        f"+ {len(sigma)} sigma commitments in {t_commit:.3f} s: "
        f"{'equal to' if ok_f and ok_s else 'DIFFERENT FROM'} build/rsa_1.pk.vk")
    if not (ok_f and ok_s):
        raise AssertionError("key commitments differ from the reference vk")
    return params, circuit, pk, sig, digest


def prove(device, params, circuit, pk, sig, digest) -> dict:
    from halo2_zkcert_tpu_torch.bench import prove_rsa
    from halo2_zkcert_tpu_torch.ops import kernels
    from halo2_zkcert_tpu_torch.plonk import prover, verify_proof
    from halo2_zkcert_tpu_torch.sdk import Snark
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    proof, instances, dt0 = prove_rsa(params, circuit, pk, sig, digest, device)
    log(f"[prove] warm-up proof {dt0:.3f} s, stages "
        f"{json.dumps(prover.LAST_STAGE_TIMES)}")
    kernels.reset_launches()
    proof, instances, dt = prove_rsa(params, circuit, pk, sig, digest, device)
    launches = dict(kernels.launches)
    log(f"[prove] timed proof {dt:.3f} s, {len(proof)} bytes, stages "
        f"{json.dumps(prover.LAST_STAGE_TIMES)}")
    t0 = time.perf_counter()
    ok = verify_proof(params, pk.vk, instances, proof, PoseidonTranscript)
    t_ver = time.perf_counter() - t0
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    rejected = not verify_proof(params, pk.vk, instances, bytes(bad),
                                PoseidonTranscript)
    log(f"[verify] accepts the proof: {ok} ({t_ver:.3f} s); rejects a "
        f"flipped byte: {rejected}")
    if not (ok and rejected):
        raise AssertionError("verifier check failed")
    ref = Snark.read(os.path.join(REPO, "build", "rsa_1.proof"))
    log(f"[prove] bytes equal to build/rsa_1.proof (information only): "
        f"{ref.proof == proof}; instances equal: {ref.instances == instances}")
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
    recs.append(check_quotient(
        device, os.path.join(REPO, "build", "rsa_1.pk.vk"), rng))
    for r in recs:
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']})")

    params_dir = os.environ.get("PARAMS_DIR",
                                os.path.join(REPO, "params"))
    params, circuit, pk, sig, digest = check_srs(device, params_dir)
    launches = prove(device, params, circuit, pk, sig, digest)
    log(f"[launches] timed proof: {json.dumps(launches, sort_keys=True)}")
    for r in recs:
        r["launches"] = launches.get(r["name"], 0)
    missing = [r["name"] for r in recs if r["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the proof: {missing}")

    print(card, flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
