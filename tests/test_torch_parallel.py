"""The sharded prover (halo2_zkcert_tpu_torch/parallel/) on `gloo` ranks over
the CPU, spawned by `parallel.mesh.run_ranks`: at world size 4 the sharded
MSM against the JAX package's `msm.msm_jacobian` (as affine points) and the
sharded transform and its inverse against the JAX package's `ntt.ntt` /
`ntt.intt`; at world size 2 the toy k=6 proof under `prover_mesh` on every
rank equal to the JAX proof's bytes (tests/data/toy_reference.npz) and
verified.

The ranks run the functions below in fresh processes, which import this
module by name: JAX is imported inside the tests only, in the parent.
"""
import json
import os

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch.ops import field, ntt
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.parallel import (make_mesh, msm_sharded_affine,
                                             ntt_sharded, prover_mesh)
from halo2_zkcert_tpu_torch.parallel.mesh import Mesh, run_ranks
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _rand(seed, count):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(count)]
    vals[:3] = [0, 1, rc.FR - 1]
    return vals


def _rank_msm_ntt(mesh, pts, scalars, cols, k):
    """One rank: the sharded MSM, and the sharded transform and its inverse
    of this rank's block of `cols`; with the mesh's traffic."""
    torch.set_num_threads(2)
    m = (1 << k) // mesh.size
    block = cols[:, mesh.rank * m:(mesh.rank + 1) * m]
    return dict(msm=msm_sharded_affine(pts, scalars, mesh),
                fwd=ntt_sharded(block, k, mesh),
                inv=ntt_sharded(block, k, mesh, inverse=True),
                bytes=mesh.bytes_sent, collectives=mesh.collectives)


def _rank_toy_proof(mesh):
    """One rank: the toy proof under `prover_mesh`, and what it launched."""
    from halo2_zkcert_tpu_torch.parallel.ntt_sharded import counts
    from halo2_zkcert_tpu_torch.plonk import (create_proof, from_reference_pk,
                                              setup, verify_proof)
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    torch.set_num_threads(2)
    ref = np.load(os.path.join(DATA, "toy_reference.npz"))
    pk = from_reference_pk(
        {k: ref[k] for k in ("fixed_lagrange", "fixed_coeff",
                             "sigma_lagrange", "sigma_coeff")},
        json.loads(ref["vk_json"].tobytes()), "cpu")
    instances = json.loads(ref["instances_json"].tobytes())
    advice = field.from_resident(FR, torch.from_numpy(ref["advice"]))
    params = setup(pk.vk.k, device="cpu")
    counts.clear()
    with prover_mesh(mesh):
        proof = create_proof(params, pk, advice, instances,
                             PoseidonTranscript())
    return dict(proof=proof, counts=dict(counts), bytes=mesh.bytes_sent,
                ok=verify_proof(params, pk.vk, instances, proof,
                                PoseidonTranscript))


def test_msm_and_ntt_sharded_over_four_ranks():
    import jax.numpy as jnp
    from halo2_zkcert_tpu.ops import curve as jcurve
    from halo2_zkcert_tpu.ops import msm as jmsm
    from halo2_zkcert_tpu.ops import ntt as jntt
    from halo2_zkcert_tpu.ops.field import Fr as JFr
    from halo2_zkcert_tpu_torch.ops import curve
    from halo2_zkcert_tpu_torch.plonk import setup
    k, n_pts = 8, 64
    params = setup(6, device="cpu")
    pts = params.g[:n_pts].contiguous()
    sc = _rand(1, n_pts)
    scalars = field.from_ints(FR, sc, "cpu")
    vals = [_rand(2, 1 << k), _rand(3, 1 << k)]
    cols = field.from_ints(FR, vals[0] + vals[1], "cpu").reshape(2, 1 << k, 8)
    res = run_ranks(_rank_msm_ntt, 4, "gloo", "cpu",
                    args=(pts, scalars, cols, k))

    acc = jmsm.msm_jacobian(
        jcurve.points_to_device(curve.points_from_device(pts)),
        JFr.from_ints(sc))
    want_msm = jcurve.points_from_device(
        jcurve.to_affine(tuple(c[None] for c in acc)))
    jcols = jnp.stack([JFr.from_ints(v) for v in vals], axis=1)
    want_f, want_i = jntt.ntt(jcols, k), jntt.intt(jcols, k)
    m = (1 << k) // 4
    for rank, out in enumerate(res):
        assert curve.points_from_device(out["msm"][None]) == want_msm
        for c in range(2):
            rows = slice(rank * m, (rank + 1) * m)
            assert field.to_ints(out["fwd"][c]) == [
                int(v) % rc.FR for v in JFr.to_ints(want_f[rows, c])]
            assert field.to_ints(out["inv"][c]) == [
                int(v) % rc.FR for v in JFr.to_ints(want_i[rows, c])]
        # one gather of the MSM's partials, three exchanges a transform
        assert out["collectives"] == 7 and out["bytes"] > 0


def test_sharded_toy_proof_over_two_ranks():
    ref = np.load(os.path.join(DATA, "toy_reference.npz"))
    res = run_ranks(_rank_toy_proof, 2, "gloo", "cpu")
    for out in res:
        assert out["proof"] == ref["proof_poseidon"].tobytes()
        assert out["ok"]
        # k=6 and its extended domain both divide by 2^2: nothing replicated
        assert out["counts"].get("sharded", 0) > 0
        assert out["counts"].get("replicated", 0) == 0


def test_mesh_of_one_process_and_its_checks(tmp_path):
    """A mesh needs an initialised group; a group of one process is a mesh
    of one rank whose collectives still run through `gloo`; collectives
    refuse unsigned types; a transform that does not divide is refused."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError):
        make_mesh(device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device="cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        t = torch.arange(6, dtype=torch.int32).reshape(3, 2)
        assert torch.equal(mesh.all_gather(t)[0], t)
        a = field.from_ints(FR, _rand(4, 32), "cpu")
        assert torch.equal(ntt_sharded(a, 5, mesh), ntt.ntt(a, 5))
        assert mesh.collectives == 4 and mesh.bytes_sent == 0
    finally:
        dist.destroy_process_group()
    two = Mesh(0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError):
        two.all_to_all(t.to(torch.uint8)[:2])
    with pytest.raises(ValueError):
        ntt_sharded(a[:1], 1, two)
