"""SHPLONK (BDFG21) batched multi-point opening.

Counterpart of halo2_zkcert_tpu/plonk/shplonk.py.  Protocol:

  prover                                   transcript
  ------                                   ----------
  (evals already written)                  y  = squeeze   (combine within set)
  h_i = sum_j y^j (p_ij - r_ij) / Z_{S_i}  v  = squeeze   (combine across sets)
  H   = sum_i v^i h_i                      write [H]
                                           u  = squeeze
  L   = Z^-1_{T\\S_0}(u) [ sum_i v^i Z_{T\\S_i}(u)(P_i - R_i(u)) - Z_T(u) H ]
  W'  = L / (X - u)                        write [W']

  verify: e([W'], [s]_2) * e(-u[W'] - [L], [1]_2) == 1

All polynomial arithmetic runs in the LAGRANGE VALUES domain: divisions by
Z_{S_i}(X) and (X - u) are pointwise products with batched inverses (the
opening points are never in H), and [H], [W'] are committed from values.
Per-set scalar math (interpolation, vanishing evaluations) is host ints.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import field, frops
from ..ops.field import FR
from ..utils import refcrypto as rc


@dataclass
class ProverQuery:
    poly: torch.Tensor    # (n, 8) Lagrange values over H
    point: int
    eval: int
    name: str = ""


@dataclass
class VerifierQuery:
    commitment: tuple     # (x, y) affine G1, or ("msm", [(pt, coeff), ...])
    point: int
    eval: int
    name: str = ""


def _group_rotation_sets(queries):
    """Group queries by polynomial, then polys by their point-set.

    Returns an ordered list of sets: each = (points_tuple, [poly entries]),
    where each poly entry is (name, per-point data dict point->query).
    Ordering: by first appearance in the query list (both sets and polys) —
    the canonical order both sides derive independently.
    """
    by_poly: dict = {}
    poly_order: list = []
    for q in queries:
        key = q.name
        if key not in by_poly:
            by_poly[key] = {}
            poly_order.append(key)
        assert q.point not in by_poly[key], f"duplicate query {key}@{q.point}"
        by_poly[key][q.point] = q
    sets: dict = {}
    set_order: list = []
    for key in poly_order:
        pts = tuple(sorted(by_poly[key].keys()))
        if pts not in sets:
            sets[pts] = []
            set_order.append(pts)
        sets[pts].append((key, by_poly[key]))
    return [(pts, sets[pts]) for pts in set_order]


def _lagrange_interpolate(points, evals):
    """Coefficients of the unique degree-<len poly through (points, evals)."""
    m = len(points)
    coeffs = [0] * m
    for i in range(m):
        # basis poly prod_{j!=i} (X - x_j) / (x_i - x_j)
        denom = 1
        basis = [1]
        for j in range(m):
            if j == i:
                continue
            denom = denom * (points[i] - points[j]) % rc.FR
            new = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                new[d + 1] = (new[d + 1] + c) % rc.FR
                new[d] = (new[d] - c * points[j]) % rc.FR
            basis = new
        scale = evals[i] * rc.finv(denom, rc.FR) % rc.FR
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % rc.FR
    return coeffs


def _eval_poly_host(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % rc.FR
    return acc


def _vanishing_eval(points, u):
    acc = 1
    for p in points:
        acc = acc * ((u - p) % rc.FR) % rc.FR
    return acc


def open_shplonk(params, queries, transcript, dom) -> None:
    """Prover side: runs the y / v / [H] / u / [W'] rounds on `transcript`."""
    rsets = _group_rotation_sets(queries)
    super_points = []
    for pts, _ in rsets:
        for p in pts:
            if p not in super_points:
                super_points.append(p)

    y = transcript.squeeze_challenge()
    combined = []          # (points, P_i = sum_j y^j p_ij, R_i coefficients)
    for pts, polys in rsets:
        evs = [0] * len(pts)
        yk, P = 1, None
        for name, qmap in polys:
            poly = qmap[pts[0]].poly
            term = poly if yk == 1 else field.mul_const(FR, poly, yk)
            P = term if P is None else field.add(FR, P, term)
            for t, p in enumerate(pts):
                evs[t] = (evs[t] + yk * qmap[p].eval) % rc.FR
            yk = yk * y % rc.FR
        combined.append((pts, P, _lagrange_interpolate(list(pts), evs)))

    v = transcript.squeeze_challenge()
    dev = combined[0][1].device
    omega = dom.omega_pows_device
    maxd = max(len(pts) for pts, _, _ in combined)
    pwd = [None, omega]
    for d in range(2, maxd):
        pwd.append(field.mul_mont(FR, pwd[-1], dom.omega_pows_mont))
    # Z_{S_i}(omega^j) = prod_z (omega^j - z), one batched inversion
    zs = []
    for pts, _, _ in combined:
        z = None
        for pt in pts:
            t = field.sub(FR, omega, field.const(FR, pt, dev))
            z = t if z is None else field.mul(FR, z, t)
        zs.append(z)
    zinv = frops.batch_inv(torch.cat(zs)).reshape(len(combined), -1, 8)
    H = None
    vk = 1
    for i, (pts, P, R) in enumerate(combined):
        r_vals = field.const(FR, R[0], dev)
        for d in range(1, len(pts)):
            r_vals = field.add(FR, field.mul_const(FR, pwd[d], R[d]), r_vals)
        h = field.mul(FR, field.sub(FR, P, r_vals), zinv[i])
        h = h if vk == 1 else field.mul_const(FR, h, vk)
        H = h if H is None else field.add(FR, H, h)
        vk = vk * v % rc.FR
    transcript.write_point(params.commit_lagrange(H))

    u = transcript.squeeze_challenge()
    zt_eval = _vanishing_eval(super_points, u)
    L = None
    vk = 1
    z_diff_0 = None
    for pts, P, R in combined:
        z_i = _vanishing_eval([p for p in super_points if p not in pts], u)
        if z_diff_0 is None:
            z_diff_0 = z_i
        term = field.sub(FR, P, field.const(FR, _eval_poly_host(R, u), dev))
        term = field.mul_const(FR, term, vk * z_i % rc.FR)
        L = term if L is None else field.add(FR, L, term)
        vk = vk * v % rc.FR
    L = field.add(FR, L, field.mul_const(FR, H, (-zt_eval) % rc.FR))
    L = field.mul_const(FR, L, rc.finv(z_diff_0, rc.FR))
    W = field.mul(FR, L, frops.batch_inv(
        field.sub(FR, omega, field.const(FR, u, dev))))
    transcript.write_point(params.commit_lagrange(W))


def verify_shplonk(params, queries, transcript) -> bool:
    """Verifier side: reads [H], [W'], does the pairing check (host)."""
    rsets = _group_rotation_sets(queries)
    super_points = []
    for pts, _ in rsets:
        for p in pts:
            if p not in super_points:
                super_points.append(p)

    y = transcript.squeeze_challenge()
    # combined commitments [P_i] and eval interpolations
    combined = []
    for pts, polys in rsets:
        P = rc.G1_IDENTITY
        yk = 1
        evs = [0] * len(pts)
        for name, qmap in polys:
            P = rc.g1_add(P, _commitment_mul(qmap[pts[0]].commitment, yk))
            for t, p in enumerate(pts):
                evs[t] = (evs[t] + yk * qmap[p].eval) % rc.FR
            yk = yk * y % rc.FR
        R = _lagrange_interpolate(list(pts), evs)
        combined.append((pts, P, R))

    v = transcript.squeeze_challenge()
    h_commit = transcript.read_point()
    u = transcript.squeeze_challenge()

    zt_eval = _vanishing_eval(super_points, u)
    L = rc.G1_IDENTITY
    const_acc = 0      # accumulated scalar multiplied by G (from R_i(u) terms)
    vk_pow = 1
    z_diff_0 = None
    for pts, P, R in combined:
        diff_pts = [p for p in super_points if p not in pts]
        z_i = _vanishing_eval(diff_pts, u)
        if z_diff_0 is None:
            z_diff_0 = z_i
        r_u = _eval_poly_host(R, u)
        w = vk_pow * z_i % rc.FR
        L = rc.g1_add(L, rc.g1_mul(P, w))   # P is Jacobian
        const_acc = (const_acc + w * r_u) % rc.FR
        vk_pow = vk_pow * v % rc.FR
    # subtract const_acc * G and zt_eval * H
    L = rc.g1_add(L, rc.g1_mul(rc.g1_from_affine(rc.G1_GEN), (-const_acc) % rc.FR))
    L = rc.g1_add(L, rc.g1_mul(rc.g1_from_affine(h_commit), (-zt_eval) % rc.FR))
    L = rc.g1_mul(L, rc.finv(z_diff_0, rc.FR))

    w_commit = transcript.read_point()
    # e([W'], [s]2) * e(-u[W'] - [L], [1]2) == 1
    lhs = rc.g1_to_affine(
        rc.g1_add(rc.g1_mul(rc.g1_from_affine(w_commit), u), L))
    return rc.pairing_check([
        (w_commit, params.s_g2),
        (rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(lhs))), params.g2),
    ])


def _commitment_mul(commitment, scalar: int):
    """Affine commitment (or lazy scaled-sum form) times scalar -> Jacobian."""
    if isinstance(commitment, tuple) and len(commitment) == 2 \
            and isinstance(commitment[0], int):
        return rc.g1_mul(rc.g1_from_affine(commitment), scalar)
    # lazy form: ("msm", [(affine_pt, coeff), ...])
    tag, terms = commitment
    assert tag == "msm"
    acc = rc.G1_IDENTITY
    for pt, c in terms:
        acc = rc.g1_add(acc, rc.g1_mul(rc.g1_from_affine(pt), c * scalar % rc.FR))
    return acc
