"""Time the port's key files at the X.509 aggregation's size on one CUDA card.

The reference CLI's aggregation subcommands save their key (`sdk.gen_pk`
with a path): `<pk>.vk` and `<pk>.npz`, the four column arrays as (m, n, 33)
int32 byte limbs, the format both packages read.  This script builds the
port's k=20 aggregation circuit over build/{rsa_1,sha256_1,rsa_2,sha256_2}
.proof (lanes 8, na 8, nl 1, fixed-vk mode, as chip_smoke.py's phase 10),
the k=20 SRS and the key on the card, then times `sdk.write_pk` into a
temporary directory under build/ and `sdk.read_pk` back (its columns must
equal the key's), and prints one JSON line: the card, each step's seconds,
the files' bytes and the arrays' bytes before compression.  The files are
deleted at the end.  `--stride s` writes only every s-th column of each
array (the whole key takes tens of minutes to compress) and adds the line's
figures scaled by the columns left out ("whole_key_scaled").

    python3 tools/torch_write_pk.py [--stride 10]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests", "data"))


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stride", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_write_pk: no CUDA device", file=sys.stderr)
        return 1
    import make_aggregation_reference as ref
    from halo2_zkcert_tpu_torch import sdk
    from halo2_zkcert_tpu_torch.circuits.aggregation import InnerSnark
    from halo2_zkcert_tpu_torch.circuits.x509_agg import \
        X509VerifierAggregationCircuit
    from halo2_zkcert_tpu_torch.plonk import setup
    from halo2_zkcert_tpu_torch.plonk.keygen import ProvingKey
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    seconds = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        log(f"[write_pk] {label}: {seconds[label]:.3f} s")
        return out

    inner = []
    for stem in ref.X509_STEMS:
        s = sdk.Snark.read(os.path.join(REPO, "build", f"{stem}.proof"))
        inner.append(InnerSnark(vk=s.vk, instances=s.instances,
                                proof=s.proof))
    circ = timed("circuit", lambda: X509VerifierAggregationCircuit(
        inner, k=ref.K_X509, lanes=ref.LANES_X509, na=ref.NA_X509))
    params = timed("srs", lambda: setup(ref.K_X509, device=device))
    pk = timed("gen_pk", lambda: sdk.gen_pk(params, circ.data))
    full = {k: getattr(pk, k).shape[0] for k in sdk.PK_ARRAYS}
    pk = ProvingKey(pk.vk, *(getattr(pk, k)[::args.stride]
                             for k in sdk.PK_ARRAYS))
    cols = {k: getattr(pk, k).shape[0] for k in sdk.PK_ARRAYS}
    n = pk.fixed_lagrange.shape[1]
    raw = sum(cols.values()) * n * 33 * 4
    with tempfile.TemporaryDirectory(prefix="write_pk_",
                                     dir=os.path.join(REPO, "build")) as d:
        path = os.path.join(d, "x509_agg.pk")
        timed("write_pk", lambda: sdk.write_pk(
            pk, path, cache_digest=circ.data.cache_digest_bytes()))
        files = {ext: os.path.getsize(path + ext) for ext in (".npz", ".vk")}
        back = timed("read_pk", lambda: sdk.read_pk(path, device,
                                                    cs=circ.data.cs))
        same = all(torch.equal(getattr(back, k), getattr(pk, k))
                   for k in sdk.PK_ARRAYS)
    scale = sum(full.values()) / sum(cols.values())
    print(json.dumps({"card": card, "k": ref.K_X509, "rows": n,
                      "columns": cols, "columns_of_the_key": full,
                      "stride": args.stride, "seconds": seconds,
                      "file_bytes": files, "array_bytes": raw,
                      "read_back_equal": same,
                      "whole_key_scaled": None if args.stride == 1 else {
                          "write_pk_s": seconds["write_pk"] * scale,
                          "read_pk_s": seconds["read_pk"] * scale,
                          "npz_bytes": files[".npz"] * scale,
                          "array_bytes": raw * scale}}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
