"""Split the RSA link's proof time between two host changes of the port.

The bench's fixed-base RSA proof (halo2_zkcert_tpu_torch/bench.py) runs on
one CUDA card in four variants, interleaved round by round in one process:

  port         as the port has it: the transcript's Poseidon permutation in
               the C++ host library, the instance column filled on the card;
  py_poseidon  the permutation in Python (`poseidon.permute_plain`);
  host_column  the instance column converted on the host int by int
               (`int.to_bytes` of each of the n values, then one copy to the
               card), as the port built it before the host library came;
  both         both of the above.

Every variant's proof must equal build/rsa_1.proof.  Prints one JSON line:
each variant's median proof seconds, its proofs and its median stage times.

    python3 tools/torch_host_split.py [--repeat 7]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def instance_lagrange_host(vals: list, n: int, device) -> torch.Tensor:
    """The instance column as the port built it before: n ints reduced and
    converted one by one on the host."""
    from halo2_zkcert_tpu_torch.ops import field
    from halo2_zkcert_tpu_torch.ops.field import FR
    xs = [int(x) % FR.modulus for x in list(vals) + [0] * (n - len(vals))]
    return torch.from_numpy(field.ints_to_words(xs)).to(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=7,
                    help="rounds; each round proves once in every variant")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_host_split: no CUDA device")
    from halo2_zkcert_tpu_torch import native
    from halo2_zkcert_tpu_torch.bench import load_rsa_link, prove_rsa
    from halo2_zkcert_tpu_torch.plonk import gen_srs, prover
    from halo2_zkcert_tpu_torch.sdk import Snark
    from halo2_zkcert_tpu_torch.transcript.poseidon import permute_plain
    params = gen_srs(17, os.environ.get("PARAMS_DIR",
                                        os.path.join(REPO, "params")))
    for lagrange in (True, False):
        params.fixed_base(lagrange)
    link = load_rsa_link()
    ref = Snark.read(os.path.join(REPO, "build", "rsa_1.proof"))
    saved = (native.poseidon_permute, prover.instance_lagrange)
    variants = {"port": saved,
                "py_poseidon": (permute_plain, saved[1]),
                "host_column": (saved[0], instance_lagrange_host),
                "both": (permute_plain, instance_lagrange_host)}
    runs = {v: {"proofs_s": [], "stages": []} for v in variants}
    try:
        for rnd in range(args.repeat + 1):            # round 0 warms up
            for name, (perm, inst) in variants.items():
                native.poseidon_permute, prover.instance_lagrange = perm, inst
                proof, instances, dt = prove_rsa(params, *link)
                if proof != ref.proof or instances != ref.instances:
                    raise AssertionError(f"{name}: proof differs from "
                                         f"build/rsa_1.proof")
                if rnd:
                    runs[name]["proofs_s"].append(dt)
                    runs[name]["stages"].append(
                        dict(prover.LAST_STAGE_TIMES))
    finally:
        native.poseidon_permute, prover.instance_lagrange = saved
    out = {}
    for name, r in runs.items():
        stages = {k: statistics.median(s[k] for s in r["stages"])
                  for k in r["stages"][0]}
        out[name] = {"median_s": statistics.median(r["proofs_s"]),
                     "proofs_s": r["proofs_s"], "stages_s": stages}
    print(json.dumps({"metric": "rsa_k17_prove_s_by_host_variant",
                      "device": torch.cuda.get_device_name(0),
                      "variants": out}))


if __name__ == "__main__":
    main()
