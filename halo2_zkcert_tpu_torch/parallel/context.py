"""Prover mesh context: route the proving pipeline over a process group.

Counterpart of halo2_zkcert_tpu/parallel/context.py.  Usage, on every rank
of a group (parallel/mesh.py):

    with prover_mesh(make_mesh()):
        proof = create_proof(params, pk, witness, instances, transcript)

While a mesh of more than one rank is active, the prover's O(n) stages
consult `active_mesh()`:
  * commitments (plonk/kzg.py) whose base length divides by the mesh size
    take `msm_sharded`: each rank a slice of the points, the partial sums
    all-gathered and folded; the fixed-base tables are not used;
  * the transforms of plonk/domain.py whose length divides by the square of
    the mesh size take `ntt_sharded` on each rank's block of rows and
    all-gather the result;
  * ops/ntt.py does not take the four-step (H2T_NTT_MXU).
Everything else runs replicated: every rank computes the same values and
absorbs the same transcript, so the proof's bytes equal the single-device
proof's on every rank.

The active mesh is kept in a `contextvars.ContextVar`, so concurrent provers
in different threads see their own.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "h2t_torch_prover_mesh", default=None)


@contextmanager
def prover_mesh(mesh):
    """Activate `mesh` for every create_proof and commitment in the block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The active Mesh, or None."""
    return _ACTIVE.get()


def multi_rank():
    """The active mesh when it has more than one rank, else None: the one
    test behind every hook."""
    mesh = _ACTIVE.get()
    return mesh if mesh is not None and mesh.size > 1 else None


def split_mesh(rows: int, square: bool = False):
    """multi_rank() when `rows` divides by its size (by its size squared
    with `square`), else None."""
    mesh = multi_rank()
    if mesh is None or rows % (mesh.size ** (2 if square else 1)):
        return None
    return mesh
