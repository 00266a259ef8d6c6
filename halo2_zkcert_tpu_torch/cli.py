"""Command-line interface: the reference's 11 subcommands on the port.

Counterpart of halo2_zkcert_tpu/cli.py (reference `cli.rs:31-212`): the
same subcommands, defaults, artifact layout and printed lines, through this
package's sdk, circuits and `gen_srs`, with one more option, `--device`
(default `cuda`; `cpu` runs the plain versions of the kernels).

    python -m halo2_zkcert_tpu_torch.cli gen-params --k 17 --device cuda

`*-zkevm-*` drives the bit-plane SHA-256 circuit (circuits/sha256.py) and
`*-unoptimized-*` the gate-level one (circuits/sha256_gate.py), as in the
reference.  `aggregation_step` is the aggregation subcommands' work after
their key, callable on a key made elsewhere.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import time

AGG_SNARKS = ["./build/rsa_1.proof", "./build/sha256_1.proof",
              "./build/rsa_2.proof", "./build/sha256_2.proof"]


def _add_agg_shape(p):
    """Aggregation packing shape (docs/AGGREGATION_DESIGN.md)."""
    p.add_argument("--lanes", type=int, default=8)
    p.add_argument("--na", type=int, default=4)
    p.add_argument("--universal", action="store_true",
                   help="witness the inner vks (VerifierUniversality::Full, "
                        "reference lib.rs:47): one agg pk serves differing "
                        "inner vks; exposes a vk-binding digest instance")


def _add_common(p, k_default: int):
    p.add_argument("--k", type=int, default=k_default)
    p.add_argument("--build-dir", default="./build")
    p.add_argument("--params-path",
                   default=os.environ.get("PARAMS_DIR", "./params"))
    p.add_argument("--device", default="cuda",
                   help="torch device of the proving work (cuda or cpu)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="halo2-zkcert-tpu-torch",
        description="zk proving for X.509 certificate chains on a CUDA GPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("download-tls-certs",
                       help="fetch a domain's TLS chain as PEM files (cli.rs:34)")
    p.add_argument("--domain", required=True)
    p.add_argument("--certs-path", default="./certs")

    p = sub.add_parser("gen-params", help="generate/cache the KZG SRS (cli.rs:44)")
    _add_common(p, 17)

    for name, helpmsg in (("gen-rsa-keys", "RSA circuit keygen (cli.rs:52)"),
                          ("prove-rsa", "RSA circuit proof (cli.rs:96)")):
        p = sub.add_parser(name, help=helpmsg)
        _add_common(p, 17)
        p.add_argument("--verify-cert-path", default="./certs/cert_3.pem")
        p.add_argument("--issuer-cert-path", default="./certs/cert_2.pem")
        p.add_argument("--pk-path", default="./build/rsa.pk")
        if name == "prove-rsa":
            p.add_argument("--proof-path", default="./build/rsa.proof")

    for name, helpmsg, stem, prove in (
            ("gen-zkevm-sha256-keys", "SHA256 bit circuit keygen (cli.rs:80)",
             "zkevm_sha256", False),
            ("gen-unoptimized-sha256-keys",
             "gate-level SHA256 keygen (cli.rs:66)", "unoptimized_sha256",
             False),
            ("prove-zkevm-sha256", "SHA256 bit circuit proof (cli.rs:128)",
             "zkevm_sha256", True),
            ("prove-unoptimized-sha256",
             "gate-level SHA256 proof (cli.rs:112)", "unoptimized_sha256",
             True)):
        p = sub.add_parser(name, help=helpmsg)
        _add_common(p, 0)
        p.add_argument("--cert-path", default="./certs/cert_3.pem")
        p.add_argument("--pk-path", default=f"./build/{stem}.pk")
        if prove:
            p.add_argument("--proof-path", default=f"./build/{stem}.proof")

    for name, helpmsg, proof in (
            ("gen-x509-agg-keys", "aggregation keygen (cli.rs:144)", None),
            ("gen-x509-agg-proof", "aggregation proof (cli.rs:166)",
             "./build/x509_agg.proof"),
            ("gen-x509-agg-evm-proof",
             "aggregation EVM proof + verifier (cli.rs:188)",
             "./build/x509_agg_evm.proof")):
        p = sub.add_parser(name, help=helpmsg)
        _add_common(p, 22)
        p.add_argument("--snarks", nargs=4, metavar="PROOF",
                       default=list(AGG_SNARKS))
        p.add_argument("--pk-path", default="./build/x509_agg.pk")
        if proof:
            p.add_argument("--proof-path", default=proof)
        if name == "gen-x509-agg-evm-proof":
            p.add_argument("--sol-path",
                           default="./X509AggregationVerifierFinal.sol")
        _add_agg_shape(p)
    return ap


def aggregation_step(cmd: str, params, pk, circuit, proof_path: str | None,
                     sol_path: str | None = None, device="cuda") -> dict:
    """The aggregation subcommands' work after `gen_pk`: the witness, then
    for `gen-x509-agg-proof` the Poseidon snark and its deferred pairing
    (`verify_aggregated`), for `gen-x509-agg-evm-proof` the Solidity
    verifier, the Keccak proof and its check in the in-process EVM.
    Raises RuntimeError when a check fails.  Returns the instances, the
    proof, the Solidity source (or None) and each step's wall seconds."""
    from . import sdk
    from .circuits.aggregation import verify_aggregated
    from .transcript import PoseidonTranscript
    if cmd not in ("gen-x509-agg-proof", "gen-x509-agg-evm-proof"):
        raise ValueError(f"not an aggregation proof command: {cmd}")
    seconds = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[label] = time.perf_counter() - t0
        return out

    witness_fn, instances = timed("witness",
                                  lambda: circuit.witness(device))
    if cmd == "gen-x509-agg-proof":
        snark = timed("gen_snark", lambda: sdk.gen_snark(
            params, pk, witness_fn, instances, proof_path))
        if not timed("verify_aggregated", lambda: verify_aggregated(
                params, pk.vk, instances, snark.proof, PoseidonTranscript)):
            raise RuntimeError("aggregated accumulator pairing failed")
        print(f"x509 agg snark written to {proof_path}")
        return dict(instances=instances, proof=snark.proof, sol=None,
                    seconds=seconds)
    sol = timed("gen_evm_verifier", lambda: sdk.gen_evm_verifier(
        params, pk.vk, [len(c) for c in instances], sol_path,
        name="X509AggregationVerifierFinal"))
    proof = timed("gen_evm_proof", lambda: sdk.gen_evm_proof(
        params, pk, witness_fn, instances, proof_path))
    if not timed("evm_verify", lambda: sdk.evm_verify(params, pk.vk,
                                                      instances, proof)):
        raise RuntimeError("the EVM verifier rejects the aggregation proof")
    print(f"x509 agg evm proof written to {proof_path}; "
          f"verifier at {sol_path}")
    return dict(instances=instances, proof=proof, sol=sol, seconds=seconds)


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.environ.setdefault("PARAMS_DIR",
                          getattr(args, "params_path", "./params"))
    if hasattr(args, "build_dir"):
        os.makedirs(args.build_dir, exist_ok=True)

    if args.cmd == "download-tls-certs":
        from .cert import download_tls_certs_from_domain
        paths = download_tls_certs_from_domain(args.domain, args.certs_path)
        print("\n".join(paths))
        return

    from .plonk import gen_srs
    device = args.device

    if args.cmd == "gen-params":
        params = gen_srs(args.k, args.params_path, device)
        print(f"srs k={params.k} cached in {args.params_path}")
        return

    from . import sdk
    from .cert import extract_public_key, extract_tbs_and_sig, parse_pem

    def load(path):
        with open(path, "rb") as f:
            return parse_pem(f.read())

    if args.cmd in ("gen-rsa-keys", "prove-rsa"):
        from .circuits.rsa import RsaCircuit
        verify_cert = load(args.verify_cert_path)
        issuer = load(args.issuer_cert_path)
        circuit = RsaCircuit(extract_public_key(issuer), k=args.k)
        params = gen_srs(args.k, args.params_path, device)
        pk = sdk.gen_pk(params, circuit.data, args.pk_path)
        if args.cmd == "gen-rsa-keys":
            print(f"rsa pk written to {args.pk_path}")
            return
        tbs, sig = extract_tbs_and_sig(verify_cert)
        digest = hashlib.sha256(tbs).digest()
        witness_fn, instances = circuit.witness(sig, digest, device)
        RsaCircuit.validate_instances(instances)   # byte-range is host-side
        sdk.gen_snark(params, pk, witness_fn, instances, args.proof_path)
        print(f"rsa snark written to {args.proof_path}")
        return

    if "unoptimized-sha256" in args.cmd:
        from .circuits.sha256_gate import Sha256GateCircuit
        cert = load(args.cert_path)
        k = args.k or 19                      # reference README.md:24
        circuit = Sha256GateCircuit(cert.tbs, k, device)
        params = gen_srs(k, args.params_path, device)
        pk = sdk.gen_pk(params, circuit.data, args.pk_path)
        if args.cmd.endswith("keys"):
            print(f"unoptimized sha256 pk written to {args.pk_path}")
            return
        sdk.gen_snark(params, pk, circuit.advice, circuit.instances,
                      args.proof_path)
        print(f"unoptimized sha256 snark written to {args.proof_path}")
        return

    if "sha256" in args.cmd:
        from .circuits.sha256 import Sha256Circuit, min_k
        cert = load(args.cert_path)
        k = args.k or min_k(len(cert.tbs))
        circuit = Sha256Circuit.build(len(cert.tbs), k)
        params = gen_srs(k, args.params_path, device)
        pk = sdk.gen_pk(params, circuit.data, args.pk_path)
        if args.cmd.endswith("keys"):
            print(f"sha256 pk written to {args.pk_path}")
            return
        advice, instances = circuit.witness(cert.tbs, device)
        sdk.gen_snark(params, pk, advice, instances, args.proof_path)
        print(f"sha256 snark written to {args.proof_path}")
        return

    if args.cmd.startswith("gen-x509-agg"):
        from .circuits.aggregation import InnerSnark
        from .circuits.x509_agg import X509VerifierAggregationCircuit
        snarks = []
        for path in args.snarks:
            s = sdk.Snark.read(path)
            snarks.append(InnerSnark(vk=s.vk, instances=s.instances,
                                     proof=s.proof))
        params = gen_srs(args.k, args.params_path, device)
        circuit = X509VerifierAggregationCircuit(
            snarks, k=args.k, lanes=args.lanes, na=args.na,
            universal=args.universal)
        rep = circuit.rows_report()
        print(f"agg circuit: tape rows {rep['tape_rows']}, "
              f"builder cells {rep['builder_cells']}, usable {rep['usable']}")
        pk = sdk.gen_pk(params, circuit.data, args.pk_path)
        if args.cmd == "gen-x509-agg-keys":
            print(f"x509 agg pk written to {args.pk_path}")
            return
        aggregation_step(args.cmd, params, pk, circuit, args.proof_path,
                         getattr(args, "sol_path", None), device)
        return

    raise SystemExit(f"unknown command {args.cmd}")


if __name__ == "__main__":
    main()
