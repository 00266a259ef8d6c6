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
vectors, then g[i] = tau^i G and g_lagrange[i] = L_i(tau) G in one
`curve.fixed_mul` launch over a window table of G (`g1_window_table`), as
the JAX package's setup takes them from its fixed_base_msm.

Commitments of full-length columns on a CUDA device with n >= 4096 take the
fixed-base flat Pippenger of ops/msm_fb.py over per-basis window tables,
built lazily and cached beside the SRS file; everything else (short
polynomials, small domains, CPU tensors) takes the variable-base Pippenger
of ops/msm.py.  Two environment knobs, read at each call: H2T_FB_MSM
(`auto`, `0` = always variable base, `1` = always fixed base) and
H2T_FB_BOUNDED=0 (ignore the value-bit hints of bounded columns).  Each
batch of commitments is the recorder's span `commit` (utils/trace.py), which
prints the reference's `[commit] <tag> x<columns>: <s>` line under
H2T_PROFILE2.

While a prover mesh of more than one rank is active (parallel/context.py),
commitments take no fixed-base tables, and those whose base length divides
by the mesh size go through parallel/msm_sharded.py, as the JAX package's
`_commit_batch` does (halo2_zkcert_tpu/plonk/kzg.py:389-430).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import curve, field, frops, msm, scan
from ..ops.field import FQ, FR
from ..ops.msm_fb import FixedBaseMsm
from ..parallel.context import multi_rank, split_mesh
from ..parallel.msm_sharded import msm_sharded
from ..utils import refcrypto as rc
from ..utils import trace

MAGIC = b"H2TPUSRS"
DEFAULT_TAU_SEED = b"halo2-zkcert-tpu-test-srs"
# columns per MSM batch: bounds the (columns x 32 windows x n) sorted points
# (64 B a point) and their prefixes (96 B) that one batch keeps alive
COMMIT_GROUP = 4
# the fixed-base path: smallest domain that takes it by default, and the
# window width of its tables
FB_MIN_N = 4096
FB_WBITS = 16


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

    def fixed_base(self, lagrange: bool) -> FixedBaseMsm:
        """The flat-Pippenger tables of one SRS basis (ops/msm_fb.py), built
        at first use; kept on this object and, where $PARAMS_DIR (default
        ./params) exists, in a file beside the SRS cache; brought back to
        the device here after `park_fixed_base`."""
        attr = "_fb_lagrange" if lagrange else "_fb_monomial"
        fb = self.__dict__.get(attr)
        if fb is None and (fb := self.__dict__.pop("_parked" + attr, None)):
            fb.unpark(self.g_lagrange if lagrange else self.g)
            self.__dict__[attr] = fb
        if fb is None:
            d = os.environ.get("PARAMS_DIR", "./params")
            tag = "lag" if lagrange else "mono"
            cache = os.path.join(
                d, f"kzg_bn254_{self.k}.fbtab{FB_WBITS}_{tag}.torch.npy") \
                if os.path.isdir(d) else None
            fb = FixedBaseMsm(self.g_lagrange if lagrange else self.g,
                              wbits=FB_WBITS, cache_path=cache)
            self.__dict__[attr] = fb
        return fb

    def park_fixed_base(self, lagrange: bool) -> None:
        """Free the device memory of one basis's tables until its next
        `fixed_base` call (the prover's big-domain residency): where their
        file holds them they are read back from it then, else they wait on
        the host.  Tables that were never built stay unbuilt."""
        attr = "_fb_lagrange" if lagrange else "_fb_monomial"
        fb = self.__dict__.pop(attr, None)
        if fb is not None:
            fb.park()
            self.__dict__["_parked" + attr] = fb

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


@lru_cache(maxsize=None)
def g1_window_table(device) -> torch.Tensor:
    """The table of G that `curve.fixed_mul` reads: (32, 256, 2, 8), at
    [w, d] the affine point d * 2^(8 w) * G in Montgomery form, [w, 0] zero.
    The 32 bases come out of one `curve.windows` launch, their multiples
    1 .. 255 out of a prefix scan of each base repeated, and all of them are
    normalized in one batched inversion; kept for each device."""
    gen = curve.from_affine(curve.points_to_device([rc.G1_GEN], device))
    bases = curve.windows(gen, 8, curve.FIXED_WINDOWS)       # (32, 1, 3, 8)
    multiples = scan.point_scan(bases.expand(-1, 255, -1, -1))
    aff = field.to_mont(FQ, curve.to_affine(multiples))
    return torch.cat((torch.zeros_like(aff[:, :1]), aff), dim=1)


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
    li = field.mul_const(FR, field.mul_mont(FR, frops.batch_inv(denom),
                                            dom.omega_pows_mont), scale)
    pts = curve.fixed_mul(torch.cat((tau_pows, li)),
                          g1_window_table(torch.device(device)))
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


def _stack(cols):
    """A tensor or a list of columns -> (m, len, 8), or None when empty."""
    if not isinstance(cols, torch.Tensor):
        cols = torch.stack(list(cols)) if len(cols) else None
    return cols if cols is not None and cols.shape[0] else None


def _fb_wanted(n: int, device: torch.device) -> bool:
    if multi_rank() is not None:
        return False
    mode = os.environ.get("H2T_FB_MSM", "auto")
    if mode in ("0", "1"):
        return mode == "1"
    return device.type == "cuda" and n >= FB_MIN_N


def _affine_ints(accs: torch.Tensor) -> list:
    return curve.points_from_device(curve.to_affine(accs))


def _fb_commit(fb: FixedBaseMsm, cols: torch.Tensor, value_bits=None,
               blind_lo=None) -> list:
    if os.environ.get("H2T_FB_BOUNDED") == "0":
        value_bits = None
    if value_bits is not None and blind_lo is not None:
        return _affine_ints(fb.msm_many_bounded(cols, value_bits, blind_lo))
    return _affine_ints(fb.msm_many(cols))


def _commit(base: torch.Tensor, cols: torch.Tensor) -> list:
    mesh = split_mesh(base.shape[0])
    out = []
    for off in range(0, cols.shape[0], COMMIT_GROUP):
        group = cols[off:off + COMMIT_GROUP]
        if mesh is not None:
            accs = msm_sharded(base, group, mesh)
        else:
            accs = msm.msm_many(base, group)
        out.extend(_affine_ints(accs))
    return out


def commit_path(params: ParamsKZG) -> str:
    """Which MSM a full-length commitment takes now: for reports."""
    return ("fixed_base" if _fb_wanted(params.n, params.g.device)
            else "variable_base")


def _commit_span(tag: str, cols: torch.Tensor):
    """A batch of commitments as the span `commit`; it ends once the points
    are host ints, so the device is done."""
    return trace.span("commit", ("H2T_PROFILE2", "commit",
                                 f"{tag} x{cols.shape[0]}"))


def commit_many_lagrange(params: ParamsKZG, cols, value_bits=None,
                         blind_lo=None) -> list:
    """Commit Lagrange-basis columns (m, n, 8) -> [(x, y)] ints.

    value_bits / blind_lo: an optional bound, rows < blind_lo are
    < 2^value_bits; the fixed-base path then does only
    ceil(value_bits / wbits) windows of bucket work a row."""
    cols = _stack(cols)
    if cols is None:
        return []
    if _fb_wanted(params.n, cols.device):
        with _commit_span(f"lag fb vb={value_bits}", cols):
            return _fb_commit(params.fixed_base(lagrange=True), cols,
                              value_bits, blind_lo)
    with _commit_span("lag vb", cols):
        return _commit(params.g_lagrange, cols)


def commit_many(params: ParamsKZG, polys) -> list:
    """Commit monomial-basis polynomials (m, deg, 8) -> [(x, y)] ints."""
    polys = _stack(polys)
    if polys is None:
        return []
    deg = polys.shape[1]
    if deg == params.n and _fb_wanted(params.n, polys.device):
        with _commit_span("mono fb", polys):
            return _fb_commit(params.fixed_base(lagrange=False), polys)
    with _commit_span("mono vb", polys):
        return _commit(params.g[:deg], polys)
