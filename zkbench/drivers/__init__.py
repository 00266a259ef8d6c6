"""One driver a circuit kind, found by a configuration's `circuit` name:
drivers/<circuit>.py defines `Driver(config, inputs, device)` with
`setup(params_dir)`, `prove(job, blinding, fault)`, `verifying_key()` and
`close()`, and optionally `artifacts() -> dict`.  A driver reaches the
program only through its public calls.

`artifacts()` gives what the jobs' statements rest on that the reference
cannot make in a run, such as inner proofs made in set-up and their
instances, as plain data only: bytes, ints and strings in lists and dicts,
no tensor and none of the program's types.  The harness reads it once the
window has closed, after `verifying_key()` and before `close()`, and hands it
to the reference (reference/<circuit>.py), which treats every artifact as a
claim: it verifies each proof among them against a key it works out itself
before it uses it, and counts as rejected every proof whose statement rests
on an artifact that fails.  A driver without the method hands over {}."""
from __future__ import annotations


def keyed(k: int, data, device, params_dir: str) -> tuple:
    """(params, pk): the SRS of 2^k rows (read from `params_dir`, or made and
    kept there), its window tables where commitments take the fixed base,
    and the proving key of the circuit `data`."""
    from halo2_zkcert_tpu_torch.plonk import gen_srs, keygen, kzg
    params = gen_srs(k, params_dir, device)
    if kzg.commit_path(params) == "fixed_base":
        for lagrange in (True, False):
            params.fixed_base(lagrange)
    return params, keygen(params, data)


def commitments(pk) -> tuple:
    """The verifying key's (fixed, permutation) commitments."""
    return list(pk.vk.fixed_commitments), list(pk.vk.permutation_commitments)
