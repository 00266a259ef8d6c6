"""EVM verifier path: counterpart of halo2_zkcert_tpu/evm/.

Reference behavior: snark-verifier's `EvmLoader` -> Yul verifier +
`gen_evm_verifier_shplonk` / `gen_evm_proof_shplonk` / `evm_verify`
(cli.rs:512-527 [dep]).  Here verification is captured as a straight-line
IR (one program per vk) with three backends:

* `gen_evm_verifier_bytecode` — assembles the IR directly into EVM
  deployment bytecode (the reference compiles Yul to bytecode [dep]);
* `evm_verify_bytecode` — deploys + calls it in the in-process EVM
  interpreter (`interp.Evm`, the revm role — SURVEY.md §2b revm row);
* `execute_ir` — direct Python executor of the same IR (fast cross-check
  of the program against the native verifier);
* `emit_solidity` — renders the IR as a Solidity artifact using the BN254
  precompiles (ecAdd 0x6, ecMul 0x7, ecPairing 0x8, modexp 0x5), matching
  the reference's `.sol` output (cli.rs:512-517).
"""
from .bytecode import (encode_calldata, evm_verify_bytecode,
                       gen_evm_verifier_bytecode)
from .interp import Evm, ExecResult
from .ir import EvmIrLoader, build_verifier_ir, execute_ir
from .solidity import emit_solidity, gen_evm_verifier
