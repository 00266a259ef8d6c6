"""Write tests/data/selfcheck_reference.json: what the JAX package's prover
prints under its debugging knobs, which the port is held to.

    JAX_PLATFORMS=cpu python tests/data/make_selfcheck_reference.py

The toy circuit (tests/test_plonk_e2e.py `build_toy`, k=6) is proved from
the key in tests/data/toy_reference.npz, its witness, instances and the
default blinding seed, once under each setting of SETTINGS (H2T_SELFCHECK
1-5, H2T_EVAL_MODE=coeff, H2T_PROFILE, H2T_PROFILE2), with the Poseidon
transcript; each proof must equal the fixture's.  Then the toy's keygen
under H2T_PROFILE.  For each run the JSON keeps the lines the JAX package
printed, a time in seconds replaced by `<s>` (`normalize`).  The slow test
tests/test_torch_selfcheck.py::test_reference_fixture_is_current
regenerates these and compares.
"""
import contextlib
import io
import json
import os
import re
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "selfcheck_reference.json")
TOY = os.path.join(HERE, "toy_reference.npz")
PK_ARRAYS = ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff")
KNOBS = ("H2T_SELFCHECK", "H2T_EVAL_MODE", "H2T_PROFILE", "H2T_PROFILE2")
SETTINGS = {f"selfcheck{i}": {"H2T_SELFCHECK": str(i)} for i in range(1, 6)}
SETTINGS.update({"eval_coeff": {"H2T_EVAL_MODE": "coeff"},
                 "profile": {"H2T_PROFILE": "1"},
                 "profile2": {"H2T_PROFILE2": "1"}})
_SECONDS = re.compile(r"-?\d+\.\d+s$")


def normalize(text: str) -> list:
    """Printed lines, stripped, a trailing `<float>s` replaced by `<s>`."""
    return [_SECONDS.sub("<s>", line.strip())
            for line in text.splitlines() if line.strip()]


@contextlib.contextmanager
def knobs(setting: dict):
    """The environment with exactly `setting` of the debugging knobs."""
    saved = {k: os.environ.pop(k, None) for k in KNOBS}
    os.environ.update(setting)
    try:
        yield
    finally:
        for k in KNOBS:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def printed(fn):
    """(fn's result, the lines it printed, normalized)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, normalize(buf.getvalue())


def reference() -> dict:
    tests = os.path.dirname(HERE)
    for d in (tests, os.path.dirname(tests)):
        if d not in sys.path:
            sys.path.insert(0, d)
    import jax.numpy as jnp
    from test_plonk_e2e import build_toy
    from halo2_zkcert_tpu.plonk import (ProvingKey, create_proof, keygen,
                                        setup)
    from halo2_zkcert_tpu.sdk import _vk_from_dict
    from halo2_zkcert_tpu.transcript import PoseidonTranscript

    z = np.load(TOY)
    data, advice, instances = build_toy()
    vk = _vk_from_dict(json.loads(z["vk_json"].tobytes()))
    params = setup(vk.k)
    out = {"proofs": {}, "keygen_profile": None}
    for name, setting in SETTINGS.items():
        pk = ProvingKey(vk=vk, **{k: jnp.asarray(z[k]) for k in PK_ARRAYS})
        with knobs(setting):
            proof, lines = printed(lambda: create_proof(
                params, pk, advice, instances, PoseidonTranscript()))
        assert proof == z["proof_poseidon"].tobytes(), name
        out["proofs"][name] = lines
        print(name, len(lines), "lines", file=sys.stderr)
    with knobs({"H2T_PROFILE": "1"}):
        _, out["keygen_profile"] = printed(lambda: keygen(params, data))
    return out


if __name__ == "__main__":
    with open(OUT, "w") as f:
        json.dump(reference(), f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", OUT)
