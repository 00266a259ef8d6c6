"""Build variants of the port's kernels and time each on the card.

    python3 tools/torch_kernel_variants.py [source ...]   # needs one CUDA card

(every source of VARIANTS unless some are named, e.g. `ntt quotient_forest`).

A variant is a copy of one CUDA source of halo2_zkcert_tpu_torch/csrc (and
of bn254.cuh) with a few constants or one line changed by text substitution
(a substitution that matches nothing fails the run, so the table cannot
drift from the sources unnoticed).  Every variant is compiled with the
flags of ops/kernels.py, all at once, loaded in place of the built library
and timed through the committed wrappers at the shapes of chip_smoke.py and
of the proof (CUDA events, warm).  Prints the card's name and power limit, each variant's
registers and spills, and one JSON line a variant.  The point scan's
variants are also compared with the source as it stands, as affine points.

The transform, field-scan and quotient variants go through chip_smoke.py's
own checks, so each is also held against its plain version, exactly.

Used to decide the tile shape of point_scan.cu, the staging of scan_madd.cu,
the tile and block size of ntt.cu, where quotient_forest.cu keeps its slots,
the block size of point_chain.cu, whether the Montgomery product is
inlined or called, and the data rows of ntt_mxu.cu (timed at
the four-step's six base DFT launches beside torch._int_mm; its timing-only
variants leave out the epilogue, a load stream or the product, to show
what sets the pace).  The chain
kernels' variants are also compared with the source as it stands, word for
word.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from halo2_zkcert_tpu_torch.ops import (curve, frops, kernels,  # noqa: E402
                                        msm_fb, ntt, scan)
from halo2_zkcert_tpu_torch.utils import refcrypto as rc  # noqa: E402

CALL = "#define H2T_MONT_MUL_CALL"
HEADER = '#include "bn254.cuh"'
LOG_TILE, NTT_THREADS = ("constexpr int NTT_LOG_TILE = 10;",
                         "constexpr int NTT_THREADS = 256;")
FS_PPT = "constexpr int FS_PPT = 8;"
PPT, THREADS = "constexpr int PS_PPT = 8;", "constexpr int PS_THREADS = 128;"
# source -> variant -> [(old text, new text)], and the tile of the variant
VARIANTS = {
    "point_scan": {
        "as_built": [],
        "product_inlined": [(CALL, "//")],
        "6_points_a_thread": [(PPT, PPT.replace("8", "6"))],
        "4_points_a_thread": [(PPT, PPT.replace("8", "4"))],
        "256_threads_x_4": [(PPT, PPT.replace("8", "4")),
                            (THREADS, THREADS.replace("128", "256"))],
    },
    "scan_madd": {
        "as_built": [],
        "product_inlined": [(CALL, "//")],
        "2_points_a_stage": [("constexpr int SM_STAGE = 1;",
                              "constexpr int SM_STAGE = 2;")],
        "64_rows_a_block": [("constexpr int SM_ROWS = 128;",
                             "constexpr int SM_ROWS = 64;"),
                            ("__launch_bounds__(SM_ROWS, 4)",
                             "__launch_bounds__(SM_ROWS, 8)")],
    },
    "point_ops": {
        "as_built": [],
        "product_called": [(HEADER, CALL + "\n" + HEADER)],
    },
    "point_chain": {
        "as_built": [],
        "product_inlined": [(CALL, "//")],
        "64_threads": [("constexpr int PC_THREADS = 128;",
                        "constexpr int PC_THREADS = 64;")],
    },
    "ntt": {
        "as_built": [],
        "product_called": [(HEADER, CALL + "\n" + HEADER)],
        "tile_2^11": [(LOG_TILE, LOG_TILE.replace("10", "11"))],
        "tile_2^9": [(LOG_TILE, LOG_TILE.replace("10", "9"))],
        "512_threads": [(NTT_THREADS, NTT_THREADS.replace("256", "512"))],
        "128_threads": [(NTT_THREADS, NTT_THREADS.replace("256", "128"))],
    },
    "field_scan": {
        "as_built": [],
        "product_called": [(HEADER, CALL + "\n" + HEADER)],
        "4_elements_a_thread": [(FS_PPT, FS_PPT.replace("8", "4"))],
    },
    "ntt_mxu": {
        "as_built": [],
        "32_byte_rows_at_cin_1": [(": cin == 1 ? DFT_TMA_J",
                                   ": cin == 0 ? DFT_TMA_J")],
        # timing only (wrong results): the epilogue's share
        "no_reduction": [
            ("dft_words_to_fe(v[0], f253, f506)", "load_fe(v[0])"),
            ("dft_words_to_fe(v[1], f253, f506)", "load_fe(v[1])")],
        "no_epilogue": [("if (k < r) {", "if (k < r && a.m < 0) {")],
        "no_epilogue_no_data_loads": [
            ("if (k < r) {", "if (k < r && a.m < 0) {"),
            ("mbar_expect_tx(fb, DFT_STAGE_BYTES);",
             "mbar_expect_tx(fb, DFT_LHS_BYTES);"),
            ("tma_load_4d(smem_addr(dat_s + jj * DFT_SLAB_BYTES), dmap, fb, "
             "c);", "(void)c;")],
        "no_epilogue_no_lhs_loads": [
            ("if (k < r) {", "if (k < r && a.m < 0) {"),
            ("mbar_expect_tx(fb, DFT_STAGE_BYTES);",
             "mbar_expect_tx(fb, DFT_TJ * DFT_SLAB_BYTES);"),
            ("tma_load_2d(smem_addr(lhs_s), lmap, fb, c[0], c[1]);", "")],
        "no_epilogue_no_product": [
            ("if (k < r) {", "if (k < r && a.m < 0) {"),
            ("        wgmma_rs(d, ", "        if (a.m < 0) wgmma_rs(d, ")],
    },
    "quotient_forest": {
        "as_built": [],
        "slots_shared": [(HEADER, "#define H2T_TAPE_SLOTS_SHARED\n" + HEADER)],
        "product_called": [(HEADER, CALL + "\n" + HEADER)],
        "slots_shared_product_called": [
            (HEADER, "#define H2T_TAPE_SLOTS_SHARED\n" + CALL + "\n" + HEADER)],
    },
}
TILES = {"6_points_a_thread": 768, "4_points_a_thread": 512}
TIMING_ONLY = {"no_reduction", "no_epilogue", "no_epilogue_no_data_loads",
               "no_epilogue_no_lhs_loads", "no_epilogue_no_product"}
NTT_LOG_TILES = {"tile_2^11": 11, "tile_2^9": 9}
FS_TILES = {"4_elements_a_thread": 512}


def build(root: str, sources) -> dict:
    """Compile every variant of `sources`, all at once; (source, variant) ->
    library."""
    procs = []
    for src in sources:
        variants = VARIANTS[src]
        text = (kernels.CSRC / f"{src}.cu").read_text()
        header = (kernels.CSRC / "bn254.cuh").read_text()
        for name, subs in variants.items():
            out, hdr = text, header
            for old, new in subs:  # in the source, else in bn254.cuh
                if old in out:
                    out = out.replace(old, new)
                elif old in hdr:
                    hdr = hdr.replace(old, new)
                else:
                    raise SystemExit(f"{src}/{name}: {old!r} not in the source")
            d = os.path.join(root, f"{src}_{name}")
            os.makedirs(d)
            with open(os.path.join(d, f"{src}.cu"), "w") as f:
                f.write(out)
            with open(os.path.join(d, "bn254.cuh"), "w") as f:
                f.write(hdr)
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   d, "-o", os.path.join(d, "lib.so"),
                   os.path.join(d, f"{src}.cu")]
            procs.append((src, name, d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = {}
    for src, name, d, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            for other in procs:
                other[3].kill()
            raise SystemExit(f"{src}/{name}: nvcc failed\n{log}")
        used = [ln.strip().removeprefix("ptxas info    : ")
                for ln in log.splitlines()
                if "Used" in ln or ("spill" in ln and " 0 bytes spill stores"
                                    not in ln)]
        print(f"[build] {src}/{name}: {used}", flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        for fn, argtypes in kernels._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[(src, name)] = lib
    return libs


def time_ntt_mxu(dev, rng, libs) -> None:
    """Each variant of csrc/ntt_mxu.cu at the six base DFT launches of the
    four-step `intt` (8, 2^17) and `coset_ntt` (8, 2^17 -> 2^19), through
    chip_smoke.py's record (every column against the plain version,
    exactly; torch._int_mm on the same product in the same call); the
    TIMING_ONLY variants, which leave out part of the epilogue, only
    timed."""
    from halo2_zkcert_tpu_torch.ops import ntt_mxu
    a = cs.random_canonical(rng, 8 << 17, dev, rc.FR).reshape(8, 1 << 17, 8)
    kernels._libs["ntt_mxu"] = next(iter(libs.values()))
    launches = (cs._capture_dft_launches(lambda: ntt_mxu.intt(a, 17))
                + cs._capture_dft_launches(lambda: ntt_mxu.coset_ntt(
                    a, 19, rc.FR_GENERATOR, out_mont=True)))
    for (src, name), lib in libs.items():
        kernels._libs[src] = lib
        row = {}
        for i, launch in enumerate(launches):
            key = f"dft{i}_r{1 << launch[1]}"
            if name in TIMING_ONLY:
                row[key + "_ms"] = cs.kernel_ms(
                    lambda: ntt_mxu.dft_s8(*launch), 5)[0]
                continue
            r = cs._dft_record(key, launch)
            row[key + "_ms"] = r["ms"]
            row[key + "_int_mm_ms"] = r["library_ms"]
        print(json.dumps({"source": src, "variant": name, **row}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(17)
    with tempfile.TemporaryDirectory() as root:
        libs = build(root, sys.argv[1:] or list(VARIANTS))
        print(cs.card_line(), flush=True)
        mxu = {k: v for k, v in libs.items() if k[0] == "ntt_mxu"}
        if mxu:
            time_ntt_mxu(dev, rng, mxu)
        libs = {k: v for k, v in libs.items() if k[0] != "ntt_mxu"}
        if not libs:
            return 0
        B, nb = 4, (1 << 16) - 1
        P = cs.sample_points(dev, B * nb, rng).reshape(B, nb, 3, 8)
        empty = torch.from_numpy(rng.random((B, nb)) < 1 / 3).to(dev)
        P = curve.select(empty, curve.identity((B, nb), dev), P).contiguous()
        T = P[:, :1 << 15].contiguous()
        flat = cs.sample_points(dev, 1 << 17, rng)
        wide = flat[torch.from_numpy(rng.integers(
            0, 1 << 17, size=(32, 1 << 17))).to(dev)].contiguous()
        aff = curve.to_affine(flat[1:65])

        def pick(R, C):
            return aff[torch.from_numpy(rng.integers(0, 64, size=(R, C)))
                       .to(dev)].contiguous()

        def digits(R, C):
            d = np.sort(rng.integers(0, 1 << 16, size=R * C))
            return torch.from_numpy(d.astype(np.int32).reshape(R, C)).to(dev)

        xy, d1 = pick(1 << 15, 64), digits(1 << 15, 64)
        xy4, d4 = pick(1 << 17, 64), digits(1 << 17, 64)
        xys, ds = pick(16408, 8), digits(16408, 8)
        Q = flat.roll(1, 0).contiguous()
        xy_var = cs.sample_affine(dev, 128 << 17, rng).reshape(128, 1 << 17,
                                                                2, 8)
        W = flat[:128].reshape(4, 32, 3, 8).contiguous()
        from halo2_zkcert_tpu_torch.plonk import kzg
        table = kzg.g1_window_table(dev)
        sc = cs.random_canonical(rng, 1 << 18, dev, rc.FR)
        want, chain_want = None, None
        for (src, name), lib in libs.items():
            kernels._libs[src] = lib
            row = {}
            if src == "point_scan":
                scan.TILE = TILES.get(name, 1024)
                got = curve.to_affine(scan.point_scan(P, reverse=True))
                want = got if want is None else want
                row["equal_to_as_built"] = bool(torch.equal(got, want))
                for key, fn, it in (
                        ("scan_reverse_4x65535_ms",
                         lambda: scan.point_scan(P, reverse=True), 10),
                        ("scan_4x32768_ms", lambda: scan.point_scan(T), 10),
                        ("row_sum_4x65535_ms",
                         lambda: scan.point_row_sum(P), 10),
                        ("scan_32x131072_ms",
                         lambda: scan.point_scan(wide), 3),
                        ("scan_affine_128x131072_ms",
                         lambda: scan.point_scan_affine(xy_var), 3)):
                    row[key] = cs.kernel_ms(fn, it)[0]
            elif src == "scan_madd":
                for key, fn, it in (
                        ("dense_32768x64_ms", lambda: msm_fb.scan_madd(xy), 10),
                        ("digits_32768x64_ms",
                         lambda: msm_fb.scan_madd(xy, d1), 10),
                        ("dense_131072x64_ms",
                         lambda: msm_fb.scan_madd(xy4), 5),
                        ("digits_131072x64_ms",
                         lambda: msm_fb.scan_madd(xy4, d4), 5),
                        ("digits_16408x8_ms",
                         lambda: msm_fb.scan_madd(xys, ds), 10)):
                    row[key] = cs.kernel_ms(fn, it)[0]
            elif src in ("ntt", "field_scan", "quotient_forest"):
                ntt.LOG_TILE = NTT_LOG_TILES.get(name, 10)
                frops.TILE = FS_TILES.get(name, 1024)
                recs = {"ntt": lambda: cs.check_ntt(dev, 17, 8, rng),
                        "field_scan": lambda: cs.check_field_scans(
                            dev, 1 << 17, rng),
                        "quotient_forest": lambda: [cs.check_quotient(
                            dev, os.path.join(REPO, "build", "rsa_1.pk.vk"),
                            rng)]}[src]()
                row = {r["name"] + "_ms": r["ms"] for r in recs}
                if src == "quotient_forest":
                    # the SHA-256 tape's 96 slots do not fit shared memory:
                    # the shared variants must refuse it, not run
                    try:
                        r = cs.check_quotient(
                            dev, os.path.join(REPO, "build",
                                              "sha256_1.pk.vk"), rng,
                            "quotient_forest[sha256 tape]")
                        row[r["name"] + "_ms"] = r["ms"]
                    except RuntimeError as e:
                        row["sha256_tape"] = f"refused: {e}"
            elif src == "point_chain":
                got = [curve.windows(flat, 16, 16), curve.horner(W, 8),
                       curve.fixed_mul(sc, table)]
                chain_want = got if chain_want is None else chain_want
                row["equal_to_as_built"] = all(
                    bool(torch.equal(a, b)) for a, b in zip(got, chain_want))
                for key, fn, it in (
                        ("windows_131072x16x16_ms",
                         lambda: curve.windows(flat, 16, 16), 3),
                        ("horner_4x32x8_ms", lambda: curve.horner(W, 8), 10),
                        ("fixed_mul_262144_ms",
                         lambda: curve.fixed_mul(sc, table), 5)):
                    row[key] = cs.kernel_ms(fn, it)[0]
            else:
                row["point_add_131072_ms"], _ = cs.kernel_ms(
                    lambda: curve.add(flat, Q), 20)
                row["point_double_131072_ms"], _ = cs.kernel_ms(
                    lambda: curve.double(flat), 20)
            print(json.dumps({"source": src, "variant": name, **row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
