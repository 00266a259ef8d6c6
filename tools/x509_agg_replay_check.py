"""The X.509 aggregation's phase-1 replay against the full pass, on a card.

Sets up the benchmark cell x509_agg_k20.oneshot from a seed (zkbench's
traffic and driver: the chain's four inner snarks, the k=20 aggregation
circuit, its replay record and key), then:

  * proves once with the replay, recording each transform's [columns,
    log2 size] (ops/ntt.py) and K4's tape (products a row, extended rows):
    the work counts of zkbench/counts/x509_agg_k20.json;
  * at that proof's challenge tau, compares the replayed phase-1 columns
    with a full pass of the program (`record_phase1`) word for word;
  * proves again at one blinding seed with the replay and with the full
    pass as phase 1: the two proofs' bytes must be equal, and both verify
    with their accumulator passing the deferred pairing.

Prints one JSON line (seconds of each step, the card, the checks).

    python3 tools/x509_agg_replay_check.py --seed 2147489001
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from zkbench import harness, traffic
    from zkbench.drivers.x509_agg import Driver
    from halo2_zkcert_tpu_torch.circuits.aggregation import verify_aggregated
    from halo2_zkcert_tpu_torch.ops import kernels, ntt
    from halo2_zkcert_tpu_torch.plonk import create_proof, quotient
    from halo2_zkcert_tpu_torch.plonk.assignment import BlindingRng
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript

    harness.use_params_dir()
    dev = torch.device("cuda", 0)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()}
    t0 = time.perf_counter()
    kernels.build_all()
    cell, config, _ = harness.load_cell("x509_agg_k20.oneshot")
    inputs = traffic.make(config, cell, args.seed)
    drv = Driver(config, inputs, dev)
    drv.setup(os.environ["PARAMS_DIR"])
    out["setup_s"] = time.perf_counter() - t0
    comp = drv.circuit.composed
    out["rows"] = comp.rows_report()
    rep = comp.prepare_replay(dev)
    out["replay"] = {"rows": rep.rows, "cells": rep.cells.numel(),
                     "levels": len(rep.levels),
                     "tape_steps": len(rep.steps)}
    cs, n = drv.circuit.data.cs, 1 << config["k"]
    ext_n = drv.pk.domain().extended_n
    tape = quotient.compile_tape(cs, n, ext_n)
    out["quotient"] = {"products_per_row": int((tape.ins[:, 0]
                                                == quotient.MUL).sum()),
                       "instructions": int(tape.ins.shape[0]),
                       "extended_rows": ext_n}

    shapes, real = [], ntt._transform

    def recording(a, k, *rest, **kw):
        shapes.append([int(a.shape[0]) if a.dim() == 3 else 1, k])
        return real(a, k, *rest, **kw)

    taus = []
    fn = drv.witness_fn

    def witness(phase, ch):
        if phase == 1:
            taus.append(ch[0])
        return fn(phase, ch)

    ntt._transform = recording
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        create_proof(drv.params, drv.pk, witness, drv.instances,
                     PoseidonTranscript(), BlindingRng(b"replay-check|count"))
        torch.cuda.synchronize()
        out["proof_s"] = time.perf_counter() - t
    finally:
        ntt._transform = real
    out["transforms"] = shapes

    t = time.perf_counter()
    out["replay_equals_full_pass"] = comp.replay_matches(taus[0])
    out["full_pass_s"] = comp.pass_seconds[-1]
    out["compare_s"] = time.perf_counter() - t

    def full(phase, ch):
        if phase == 0:
            return fn(0, ch)
        return {i: w.to(dev) for i, w in comp.record_phase1(ch[0]).items()}

    proofs = {}
    for name, w in (("replay", fn), ("full_pass", full)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        proofs[name] = create_proof(drv.params, drv.pk, w, drv.instances,
                                    PoseidonTranscript(),
                                    BlindingRng(b"replay-check|bytes"))
        torch.cuda.synchronize()
        out[f"{name}_proof_s"] = time.perf_counter() - t
        out[f"{name}_blake2b"] = hashlib.blake2b(proofs[name],
                                                 digest_size=16).hexdigest()
    out["proof_bytes_equal"] = proofs["replay"] == proofs["full_pass"]
    out["verify_aggregated"] = verify_aggregated(
        drv.params, drv.pk.vk, drv.instances, proofs["replay"],
        PoseidonTranscript)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(json.dumps(out), flush=True)
    ok = (out["replay_equals_full_pass"] and out["proof_bytes_equal"]
          and out["verify_aggregated"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
