"""Write tests/data/bigdomain_reference.npz: the JAX package's
coset-separated quotient (plonk/prover.py `_quotient_fn_coset`) on the toy
circuit's proving key, which tests/test_torch_bigdomain.py holds the port's
coset pieces against.

    JAX_PLATFORMS=cpu python tests/data/make_bigdomain_reference.py

The key is tests/data/toy_reference.npz's (k=6); the fresh Lagrange columns
and the challenges are `inputs(cs, seed)`'s, seeded numpy draws that the
test makes again.  Its JAX programs take about 75 s to compile on the CPU;
the slow test `test_reference_fixture_is_current` regenerates and compares.
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "bigdomain_reference.npz")
TOY = os.path.join(HERE, "toy_reference.npz")
PK_ARRAYS = ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff")
SEEDS = (0, 1)
FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


def fresh_counts(cs) -> list:
    """Columns of each fresh source, in the quotient's order: advice,
    instance, permutation Zs, lookup Zs, permuted inputs, permuted
    tables."""
    nl = len(cs.lookups)
    return [cs.num_advice, cs.num_instance, cs.num_permutation_chunks(),
            nl, nl, nl]


def inputs(cs, n: int, seed: int) -> tuple:
    """(fresh columns: a list of n-row lists of Fr ints, challenges: the
    4 + num_challenges Fr ints), drawn with numpy from `seed`."""
    rng = np.random.default_rng(seed)

    def draw(count):
        return [int.from_bytes(rng.bytes(32), "little") % FR
                for _ in range(count)]

    cols = [draw(n) for _ in range(sum(fresh_counts(cs)))]
    return cols, draw(4 + cs.num_challenges)


def to_bytes(vals) -> np.ndarray:
    """Fr ints -> (len, 32) little-endian bytes."""
    return np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                         np.uint8).reshape(-1, 32)


def reference() -> dict:
    """The JAX package's coset pieces for each seed, (qd, n, 32) bytes."""
    root = os.path.dirname(os.path.dirname(HERE))
    if root not in sys.path:
        sys.path.insert(0, root)
    import jax.numpy as jnp
    from halo2_zkcert_tpu.ops.field import Fr
    from halo2_zkcert_tpu.plonk import prover
    from halo2_zkcert_tpu.plonk.keygen import ProvingKey
    from halo2_zkcert_tpu.sdk import _vk_from_dict

    z = np.load(TOY)
    vk = _vk_from_dict(json.loads(z["vk_json"].tobytes()))
    pk = ProvingKey(vk, *(jnp.asarray(z[k]) for k in PK_ARRAYS))
    cs, n = vk.cs, 1 << vk.k
    run = prover._quotient_fn_coset(pk)
    out = {}
    for seed in SEEDS:
        cols, chal = inputs(cs, n, seed)
        groups, off = [], 0
        for m in fresh_counts(cs):
            groups.append([Fr.from_ints(c) for c in cols[off:off + m]])
            off += m
        pieces = run(*groups, jnp.stack([Fr.from_ints([c])[0]
                                         for c in chal]))
        qd = pieces.shape[0]
        vals = Fr.to_ints(pieces.reshape(qd * n, -1))
        out[f"pieces_{seed}"] = to_bytes([int(v) for v in vals]).reshape(
            qd, n, 32)
    return out


if __name__ == "__main__":
    np.savez_compressed(OUT, **reference())
    print("wrote", OUT)
