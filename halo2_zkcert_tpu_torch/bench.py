"""The main path: one RSA-2048 PKCS#1 v1.5 link proved at k=17.

The leaf testdata/example_cert_3.pem, signed by testdata/example_cert_2.pem,
through `RsaCircuit` with the committed proving key build/rsa_1.pk.{npz,vk}
(the JAX package's keygen output, carried across by sdk.read_pk), a Poseidon
transcript, and the port's verifier.

    python -m halo2_zkcert_tpu_torch.bench [--repeat N]

prints one JSON line; it needs a CUDA device.  The line names the commitment
path that ran (`commit_path`: the fixed-base MSM by default, the
variable-base one under H2T_FB_MSM=0) and each kernel's launches on the last
timed proof; the fixed-base window tables are built before the timed region
(`tables_s`).  A proof's device time by kernel, its idle share and what the
host did in each idle gap come from the benchmark's traced run
(`python3 zkbench/run.py --workload rsa2048_k17.solo --seed <n> --seconds 51
--trace 1`).
With --sweep-scan-c no proof runs: the line carries the time of one group of
four full columns and of one bounded 16-bit column through the fixed-base
MSM for each row length of the scan kernel, forced in place of what
ops/msm_fb.scan_row_length picks, and the row length it does pick.
With --cios-rate no proof runs either: the line carries the rate of bare
256-bit Montgomery products on the card (csrc/cios_rate.cu), and the latency
of one such product in a chain that a single thread carries.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_rsa_link(device="cuda"):
    """(circuit, pk, signature, digest) of the benchmark link."""
    from .cert import extract_public_key, extract_tbs_and_sig, parse_pem
    from .circuits.rsa import RsaCircuit
    from .sdk import read_pk

    def load(name):
        with open(os.path.join(REPO, "testdata", name), "rb") as f:
            return parse_pem(f.read())

    inter, leaf = load("example_cert_2.pem"), load("example_cert_3.pem")
    circuit = RsaCircuit(extract_public_key(inter), k=17)
    pk = read_pk(os.path.join(REPO, "build", "rsa_1.pk"), device,
                 cs=circuit.cs)
    tbs, sig = extract_tbs_and_sig(leaf)
    return circuit, pk, sig, hashlib.sha256(tbs).digest()


def prove_rsa(params, circuit, pk, sig: int, digest: bytes, device="cuda"):
    """One proof of the link: (proof bytes, instances, seconds)."""
    from .plonk import create_proof
    from .transcript import PoseidonTranscript
    t0 = time.perf_counter()
    witness_fn, instances = circuit.witness(sig, digest, device)
    proof = create_proof(params, pk, witness_fn, instances,
                         PoseidonTranscript())
    return proof, instances, time.perf_counter() - t0


def _cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the device (CUDA events) after one
    untimed call."""
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


def sweep_scan_c(params, widths=(8, 16, 32, 64)) -> dict:
    """Milliseconds (CUDA events, mean of 3 after a warm-up) of
    `msm_many` over four full random columns and of `msm_many_bounded` over
    one 16-bit column with a 6-row blinding tail, per scan row length
    ("picked": the row length left to `scan_row_length`)."""
    import numpy as np

    from .ops import msm_fb
    dev, n = params.g.device, params.n
    fb = params.fixed_base(lagrange=True)
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, size=(5, n, 8), dtype=np.uint64)
    words[..., 7] >>= 4                                # below r
    cols = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    small = cols[4:].clone()
    small[0, :n - 6, 1:] = 0
    small[0, :n - 6, 0] &= 0xFFFF
    saved, out = msm_fb.scan_row_length, {}
    picked = {}
    fb.msm_many(cols[:4])          # the allocator's first growth is not timed
    fb.msm_many_bounded(small, 16, n - 6)
    try:
        for C in widths + ("picked",):
            if C == "picked":
                msm_fb.scan_row_length = \
                    lambda pairs: picked.setdefault(pairs, saved(pairs))
            else:
                msm_fb.scan_row_length = lambda pairs, C=C: C
            row = {}
            for name, fn in (
                    ("full4_ms", lambda: fb.msm_many(cols[:4])),
                    ("bounded1_ms", lambda: fb.msm_many_bounded(small, 16,
                                                                n - 6))):
                row[name] = _cuda_ms(fn, 3)
            out[str(C)] = row
    finally:
        msm_fb.scan_row_length = saved
    out["picked"]["row_length_by_pairs"] = picked
    return out


def cios_latency_s(device, iters: int = 1 << 14) -> float:
    """Seconds of one Montgomery product in a chain of dependent ones that a
    single thread carries alone (CUDA events, mean of 3 after a warm-up):
    the floor under any kernel that is one such chain."""
    from .ops import kernels
    lib = kernels.lib("cios_rate")
    seed = torch.arange(3, 19, dtype=torch.int32, device=device)
    sink = torch.empty(1, dtype=torch.int32, device=device)

    def launch():
        kernels.check(lib.h2t_cios_rate(seed.data_ptr(), sink.data_ptr(), 1,
                                        1, 1, iters,
                                        kernels.stream_ptr(seed.device)),
                      "cios_rate")
    return _cuda_ms(launch, 3) * 1e-3 / iters


def cios_rate(device) -> dict:
    """Products a second of the kernels' own CIOS Montgomery product with
    every SM full and 1, 2 or 4 independent chains a thread (CUDA events,
    mean of 5 after a warm-up), and the same as 32-bit multiply-add
    operations at the 544 a product that the kernels' bounds count; and the
    latency of one product in a single thread's chain."""
    from .ops import kernels
    lib = kernels.lib("cios_rate")
    threads, iters = 256, 2048
    blocks = 8 * torch.cuda.get_device_properties(
        device).multi_processor_count
    seed = torch.arange(3, 19, dtype=torch.int32, device=device)
    sink = torch.empty(blocks * threads, dtype=torch.int32, device=device)
    out = {}
    for chains in (1, 2, 4):
        def launch():
            kernels.check(lib.h2t_cios_rate(
                seed.data_ptr(), sink.data_ptr(), blocks, threads, chains,
                iters, kernels.stream_ptr(seed.device)), "cios_rate")
        per_s = blocks * threads * chains * iters / (
            _cuda_ms(launch, 5) * 1e-3)
        out[f"chains_{chains}"] = {"products_per_s": per_s,
                                   "operations_per_s": per_s * 544}
    out["one_thread_latency_s"] = cios_latency_s(device)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=1,
                    help="timed proofs after the warm-up; value = the median")
    ap.add_argument("--sweep-scan-c", action="store_true",
                    help="time the fixed-base MSM per scan row length; no proof")
    ap.add_argument("--cios-rate", action="store_true",
                    help="time bare Montgomery products; no proof")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench: no CUDA device")
    if args.cios_rate:
        print(json.dumps({"metric": "cios_products_per_s",
                          "device": torch.cuda.get_device_name(0),
                          "value": cios_rate(torch.device("cuda", 0))}))
        return
    from .ops import kernels
    from .plonk import gen_srs, kzg, prover, verify_proof
    from .transcript import PoseidonTranscript
    params = gen_srs(17, os.environ.get("PARAMS_DIR",
                                        os.path.join(REPO, "params")))
    if args.sweep_scan_c:
        print(json.dumps({"metric": "fixed_base_msm_ms_by_scan_c",
                          "device": torch.cuda.get_device_name(0),
                          "value": sweep_scan_c(params)}))
        return
    path = kzg.commit_path(params)
    t0 = time.perf_counter()
    if path == "fixed_base":
        for lagrange in (True, False):
            params.fixed_base(lagrange)
        torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    circuit, pk, sig, digest = load_rsa_link()
    proof, instances, _ = prove_rsa(params, circuit, pk, sig, digest)
    assert verify_proof(params, pk.vk, instances, proof, PoseidonTranscript)
    times = []
    for _ in range(max(1, args.repeat)):
        kernels.reset_launches()
        times.append(prove_rsa(params, circuit, pk, sig, digest)[2])
    out = {"metric": "rsa_k17_prove_s", "value": sorted(times)[len(times) // 2],
           "unit": "s", "proofs_s": times, "commit_path": path,
           "tables_s": tables_s, "launches": dict(kernels.launches),
           "device": torch.cuda.get_device_name(0),
           "stages_s": dict(prover.LAST_STAGE_TIMES)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
