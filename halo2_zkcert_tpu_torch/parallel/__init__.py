"""The sharded prover over torch.distributed (SURVEY.md §2c).

Counterpart of halo2_zkcert_tpu/parallel/:

* MSM: points and scalars split over the ranks; each rank runs the local
  variable-base Pippenger, the D partial sums (96 bytes a column each) are
  all-gathered and folded with K2 (msm_sharded.py).
* NTT: the four-step factorization over the ranks, three all-to-all
  exchanges around two local transforms and one twiddle product
  (ntt_sharded.py), where XLA's SPMD partitioner placed them for the JAX
  package.
* Everything else replicated on every rank (context.py).
"""
from .context import active_mesh, prover_mesh
from .mesh import default_mesh, make_mesh
from .msm_sharded import msm_sharded, msm_sharded_affine
from .ntt_sharded import ntt_sharded
