"""One driver a circuit kind, found by a configuration's `circuit` name:
drivers/<circuit>.py defines `Driver(config, inputs, device)` with
`setup(params_dir)`, `prove(job, blinding, fault)`, `verifying_key()` and
`close()`.  A driver reaches the program only through its public calls."""
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
