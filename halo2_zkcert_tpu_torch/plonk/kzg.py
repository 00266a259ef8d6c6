"""KZG parameters (SRS) over BN254 and batched commitments.

Counterpart of halo2_zkcert_tpu/plonk/kzg.py.  Same artifact format
(`$PARAMS_DIR/kzg_bn254_{k}.srs`):
  magic b"H2TPUSRS" | k:u32 LE |
  g           n * 64 bytes (x || y, 32-byte LE each, canonical affine)
  g_lagrange  n * 64 bytes
  g2, s_g2    2 * 128 bytes (x.c0 x.c1 y.c0 y.c1, 32-byte LE)
With canonical words the point tables ARE these bytes.

The SRS is built on the device from the default tau: tau^i and the
Lagrange values L_i(tau) = omega^i (tau^n - 1) / (n (tau - omega^i)) as Fr
vectors, then g[i] = tau^i G and g_lagrange[i] = L_i(tau) G with one
batched `curve.scalar_mul` (K2 and K3).  Commitments run the variable-base
Pippenger of ops/msm.py.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve, field, frops, msm
from ..ops.field import FR
from ..utils import refcrypto as rc

MAGIC = b"H2TPUSRS"
DEFAULT_TAU_SEED = b"halo2-zkcert-tpu-test-srs"
# columns per MSM batch: bounds the (columns x 32 windows x n) sorted point
# tables (96 B a point) that one batch keeps alive
COMMIT_GROUP = 4


def _default_tau() -> int:
    d = rc.blake2b(DEFAULT_TAU_SEED, 64)
    return rc.fr_from_u512_le(d[:32], d[32:])


@dataclass
class ParamsKZG:
    k: int
    g: torch.Tensor            # (n, 2, 8) monomial-basis SRS, affine
    g_lagrange: torch.Tensor   # (n, 2, 8) Lagrange-basis SRS, affine
    g2: tuple                  # ((x.c0, x.c1), (y.c0, y.c1)) ints
    s_g2: tuple

    @property
    def n(self) -> int:
        return 1 << self.k

    def commit_lagrange(self, values: torch.Tensor):
        return commit_many_lagrange(self, values[None])[0]

    # ---- serialization -------------------------------------------------------

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(MAGIC)
            f.write(int(self.k).to_bytes(4, "little"))
            for arr in (self.g, self.g_lagrange):
                f.write(arr.cpu().numpy().astype("<i4").tobytes())
            for pt in (self.g2, self.s_g2):
                (x0, x1), (y0, y1) = pt
                for v in (x0, x1, y0, y1):
                    f.write(rc.fe_to_bytes_le(v))

    @staticmethod
    def read(path: str, device="cuda") -> "ParamsKZG":
        with open(path, "rb") as f:
            assert f.read(8) == MAGIC, "bad srs magic"
            k = int.from_bytes(f.read(4), "little")
            n = 1 << k
            tabs = []
            for _ in range(2):
                raw = np.frombuffer(f.read(64 * n), dtype="<i4")
                tabs.append(torch.from_numpy(raw.reshape(n, 2, 8).copy())
                            .to(device))
            pts = []
            for _ in range(2):
                vs = [rc.fe_from_bytes_le(f.read(32)) for _ in range(4)]
                pts.append(((vs[0], vs[1]), (vs[2], vs[3])))
        return ParamsKZG(k, tabs[0], tabs[1], pts[0], pts[1])


def setup(k: int, tau: int | None = None, device="cuda") -> ParamsKZG:
    """SRS for domain size 2^k, built on `device`."""
    from .domain import Domain
    if tau is None:
        tau = _default_tau()
    n = 1 << k
    tau_t = field.const(FR, tau, device)
    tau_pows = frops.powers(tau_t, n)                              # tau^i
    dom = Domain(k, 1, str(device))
    omega_pows = dom.omega_pows_device
    denom = field.sub(FR, tau_t, omega_pows)                       # tau - w^i
    scale = (pow(tau, n, rc.FR) - 1) * rc.finv(n, rc.FR) % rc.FR
    li = field.mul(FR, field.mul(FR, omega_pows, frops.batch_inv(denom)),
                   field.const(FR, scale, device))
    gen = curve.from_affine(curve.points_to_device([rc.G1_GEN], device))
    pts = curve.scalar_mul(gen.expand(2 * n, 3, 8).contiguous(),
                           torch.cat((tau_pows, li)))
    aff = curve.to_affine(pts)
    g2 = (rc.G2_GEN_X, rc.G2_GEN_Y)
    return ParamsKZG(k, aff[:n].contiguous(), aff[n:].contiguous(), g2,
                     rc.g2_mul_affine(g2, tau))


def gen_srs(k: int, params_dir: str | None = None, device="cuda") -> ParamsKZG:
    """Read-or-create the cached SRS ($PARAMS_DIR/kzg_bn254_{k}.srs)."""
    d = params_dir or os.environ.get("PARAMS_DIR", "./params")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"kzg_bn254_{k}.srs")
    if os.path.exists(path):
        return ParamsKZG.read(path, device)
    params = setup(k, device=device)
    params.write(path)
    return params


def _commit(base: torch.Tensor, cols) -> list:
    if not isinstance(cols, torch.Tensor):
        if not len(cols):
            return []
        cols = torch.stack(list(cols))
    out = []
    for off in range(0, cols.shape[0], COMMIT_GROUP):
        accs = msm.msm_many(base, cols[off:off + COMMIT_GROUP])
        out.extend(curve.points_from_device(curve.to_affine(accs)))
    return out


def commit_many_lagrange(params: ParamsKZG, cols) -> list:
    """Commit Lagrange-basis columns (m, n, 8) -> [(x, y)] ints."""
    return _commit(params.g_lagrange, cols)


def commit_many(params: ParamsKZG, polys) -> list:
    """Commit monomial-basis polynomials (m, deg, 8) -> [(x, y)] ints."""
    if not isinstance(polys, torch.Tensor):
        if not len(polys):
            return []
        polys = torch.stack(list(polys))
    return _commit(params.g[:polys.shape[1]], polys)
