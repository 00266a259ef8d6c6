"""Write tests/data/msm_fb_reference.npz: inputs made from numpy seeds and
what the JAX package computes from them on the fixed-base commitment path,
which the port's fast tests (tests/test_torch_msm_fb.py) are held against.

    JAX_PLATFORMS=cpu python tests/data/make_msm_fb_reference.py

Takes tens of minutes on a CPU: the Pallas kernels run in interpret mode
(set up as tests/test_pallas_kernels.py does) and the fixed-base MSM
programs compile slowly.  Field elements and coordinates are stored as
32-byte little-endian integers, framework-neutral; the JAX kernels' outputs
as the package's own limbs.  The slow test
tests/test_torch_msm_fb.py::test_reference_fixture_is_current regenerates
the file's arrays and compares.
"""
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "msm_fb_reference.npz")
SCAN_ROWS, SCAN_C = 3, 64
BLIND_LO = 12


def _bytes(ints) -> np.ndarray:
    """Nested lists of ints -> uint8 array with a trailing axis of 32."""
    a = np.array(ints, dtype=object)
    flat = b"".join(int(v).to_bytes(32, "little") for v in a.reshape(-1))
    return np.frombuffer(flat, np.uint8).reshape(a.shape + (32,)).copy()


def ints(arr) -> list:
    """Inverse of `_bytes` for an (N, 32) array."""
    return [int.from_bytes(bytes(r), "little") for r in np.asarray(arr)]


def inputs() -> dict:
    """The inputs, from numpy seeds and the Python-int oracle only."""
    root = os.path.dirname(os.path.dirname(HERE))
    if root not in sys.path:
        sys.path.insert(0, root)
    from halo2_zkcert_tpu.utils import refcrypto as rc
    G = rc.g1_from_affine(rc.G1_GEN)
    mult, acc = [], G
    for _ in range(SCAN_ROWS * SCAN_C):
        mult.append(rc.g1_to_affine(acc))
        acc = rc.g1_add(acc, G)
    rng = np.random.default_rng(2)

    def scalar():
        return int.from_bytes(rng.bytes(32), "little") % rc.FR

    # mixed add: P projective (identity, Q, -Q, then random with random Z)
    qs = [rc.g1_to_affine(rc.g1_mul(G, scalar())) for _ in range(8)]
    ps = [rc.g1_to_affine(rc.g1_mul(G, scalar())) for _ in range(8)]
    ps[1] = qs[1]
    ps[2] = rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(qs[2])))
    P = []
    for i, (x, y) in enumerate(ps):
        z = 1 if i < 4 else int.from_bytes(rng.bytes(32), "little") % rc.FQ
        P.append([x * z % rc.FQ, y * z % rc.FQ, z])
    P[0] = [0, 1, 0]
    # scan rows of table-like points; row 1 repeats one point
    rows = [mult[r * SCAN_C:(r + 1) * SCAN_C] for r in range(SCAN_ROWS)]
    rows[1] = [mult[5]] * SCAN_C
    # MSM scalars
    call8 = [scalar() for _ in range(8)]
    call8[0], call8[1] = 0, rc.FR - 1
    many8 = [[scalar() for _ in range(8)] for _ in range(2)]
    bounded16 = []
    for _ in range(3):
        col = [int(v) for v in rng.integers(0, 1 << 16, size=16)]
        col[BLIND_LO:] = [scalar() for _ in range(16 - BLIND_LO)]
        bounded16.append(col)
    streamed16 = [[scalar() for _ in range(16)] for _ in range(2)]
    ragged5 = [scalar() for _ in range(5)]
    return {
        "madd_P": _bytes(P), "madd_Q": _bytes([list(q) for q in qs]),
        "scan_xy": _bytes([[list(p) for p in row] for row in rows]),
        "base16": _bytes([list(p) for p in mult[:16]]),
        "digit_vals": _bytes([0, 1, rc.FR - 1, 0x1234_5678_9ABC_DEF0]),
        "call8": _bytes(call8), "many8": _bytes(many8),
        "bounded16": _bytes(bounded16), "streamed16": _bytes(streamed16),
        "ragged5": _bytes(ragged5),
    }


def reference(log=lambda *a: None) -> dict:
    """The inputs and the JAX package's outputs for them."""
    out = inputs()
    import jax.numpy as jnp
    from halo2_zkcert_tpu.ops import curve, limbs, msm_fb, pallas_limbs
    from halo2_zkcert_tpu.ops.field import FQ, Fq, Fr
    from halo2_zkcert_tpu.utils import refcrypto as rc
    t0 = time.time()

    def fq(arr):
        a = np.asarray(arr)
        return Fq.from_ints(ints(a.reshape(-1, 32))).reshape(
            a.shape[:-1] + (limbs.NLIMBS,))

    def fr(arr):
        a = np.asarray(arr)
        return Fr.from_ints(ints(a.reshape(-1, 32))).reshape(
            a.shape[:-1] + (limbs.NLIMBS,))

    P = tuple(fq(out["madd_P"][:, c]) for c in range(3))
    Q = tuple(fq(out["madd_Q"][:, c]) for c in range(2))
    out["madd_xla"] = np.asarray(jnp.stack(curve.add_mixed(P, Q)))
    saved = (pallas_limbs._INTERPRET, limbs._pallas_env, curve._pallas_mode)
    pallas_limbs._INTERPRET, limbs._pallas_env, curve._pallas_mode = \
        True, "1", "1"
    try:
        out["madd_pallas"] = np.asarray(jnp.stack(
            pallas_limbs.fused_point_add_mixed(P, Q, FQ.modulus)))
        log("madd", time.time() - t0)
        xy = fq(out["scan_xy"])
        out["scan_pallas"] = np.asarray(jnp.stack(
            pallas_limbs.fused_scan_madd(xy[:, :, 0], xy[:, :, 1],
                                         FQ.modulus)))
        log("scan", time.time() - t0)
    finally:
        pallas_limbs._INTERPRET, limbs._pallas_env, curve._pallas_mode = saved

    out["digits16"] = np.asarray(msm_fb._digits(fr(out["digit_vals"]), 16))
    base16 = np.asarray(fq(out["base16"])).astype(np.int32)
    out["table8_n8"] = np.asarray(msm_fb.build_tables(base16[:8], 8))
    log("tables", time.time() - t0)

    def affine(acc):
        vals = [limbs.limbs_to_int(np.asarray(c)) % rc.FQ for c in acc]
        zi = rc.finv(vals[2], rc.FQ) if vals[2] else 0
        return [vals[0] * zi % rc.FQ, vals[1] * zi % rc.FQ]

    def affine_many(accs):
        return _bytes([affine(accs[m]) for m in range(accs.shape[0])])

    fb8 = msm_fb.FixedBaseMsm(base16[:8], wbits=8)
    out["fb_call8"] = _bytes(affine(fb8(fr(out["call8"]))))
    out["fb_many8"] = affine_many(fb8.msm_many(fr(out["many8"])))
    log("fb8", time.time() - t0)
    # 5 points: a pair count that is not whole scan rows in either package
    fb5 = msm_fb.FixedBaseMsm(base16[:5], wbits=8)
    out["fb_ragged5"] = _bytes(affine(fb5(fr(out["ragged5"]))))
    log("ragged5", time.time() - t0)
    fb16 = msm_fb.FixedBaseMsm(base16, wbits=8)
    out["fb_bounded16"] = affine_many(fb16.msm_many_bounded(
        fr(out["bounded16"]), value_bits=16, blind_lo=BLIND_LO))
    log("bounded16", time.time() - t0)
    # the streamed path, forced as tests/test_msm_fixed_base.py forces it
    fb16.STREAM_PAIRS = 1
    saved_chunk = msm_fb.CHUNK
    msm_fb.CHUNK = (34 * 16) // 2
    try:
        cols = fr(out["streamed16"])
        out["fb_streamed16"] = affine_many(fb16.msm_many(cols))
        out["fb_streamed_call16"] = _bytes(affine(fb16(cols[0])))
    finally:
        msm_fb.CHUNK = saved_chunk
    log("streamed16", time.time() - t0)
    return out


if __name__ == "__main__":
    np.savez_compressed(OUT, **reference(log=print))
    print("wrote", OUT)
