"""Evaluation domain: a 2^k subgroup H = <omega> of Fr*, its extended coset
g * H_ext of size 2^extended_k, and Z_H(X) = X^n - 1.

Counterpart of halo2_zkcert_tpu/plonk/domain.py; device tables are built on
the domain's `device` and cached there.  While a prover mesh of more than one
rank is active, a transform whose length divides by the square of its size
is split over it (parallel/ntt_sharded.py `transform_gathered`) and its
result all-gathered; any other runs replicated and is counted.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import torch

from ..ops import field, ntt
from ..ops.field import FR
from ..parallel.context import multi_rank, split_mesh
from ..parallel.ntt_sharded import counts as sharded_counts, transform_gathered
from ..utils import refcrypto as rc


@dataclass(frozen=True)
class Domain:
    k: int
    quotient_degree: int   # max gate degree - 1
    device: str = "cuda"

    G_COSET = rc.FR_GENERATOR

    @cached_property
    def n(self) -> int:
        return 1 << self.k

    @cached_property
    def extended_k(self) -> int:
        need = self.n * max(self.quotient_degree, 1)
        ek = self.k
        while (1 << ek) < need:
            ek += 1
        return ek

    @cached_property
    def extended_n(self) -> int:
        return 1 << self.extended_k

    @cached_property
    def omega(self) -> int:
        return rc.fr_root_of_unity(self.k)

    @cached_property
    def omega_inv(self) -> int:
        return rc.finv(self.omega, rc.FR)

    @cached_property
    def extended_omega(self) -> int:
        return rc.fr_root_of_unity(self.extended_k)

    # ---- host scalars -------------------------------------------------------

    def rotate_omega(self, x: int, rotation: int) -> int:
        """x * omega^rotation (rotation may be negative)."""
        if rotation >= 0:
            return x * pow(self.omega, rotation, rc.FR) % rc.FR
        return x * pow(self.omega_inv, -rotation, rc.FR) % rc.FR

    def l_i_range(self, x: int, xn: int, idxs) -> list:
        """L_i(x) = (omega^i / n) (x^n - 1) / (x - omega^i)."""
        out = []
        zh = (xn - 1) % rc.FR
        n_inv = rc.finv(self.n, rc.FR)
        for i in idxs:
            wi = pow(self.omega, i % self.n, rc.FR)
            denom = (x - wi) % rc.FR
            out.append(zh * wi % rc.FR * n_inv % rc.FR
                       * rc.finv(denom, rc.FR) % rc.FR)
        return out

    def bary_scale(self, x: int) -> int:
        """(x^n - 1) / n, the shared barycentric weight scale for x."""
        return (pow(x, self.n, rc.FR) - 1) % rc.FR \
            * rc.finv(self.n, rc.FR) % rc.FR

    # ---- device transforms (columns along axis -2) --------------------------

    @staticmethod
    def _over_mesh(a, k, inverse, g=None, mont=False):
        """The transform split over the active mesh when there is one of
        several ranks and 2^k divides by its size squared, else None (a
        transform left replicated under such a mesh is counted)."""
        mesh = split_mesh(1 << k, square=True)
        if mesh is None:
            if multi_rank() is not None:
                sharded_counts["replicated"] += 1
            return None
        sharded_counts["sharded"] += 1
        return transform_gathered(a, k, mesh, inverse, g, mont)

    def lagrange_to_coeff(self, values: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
        """Into `out` when given."""
        res = self._over_mesh(values, self.k, True)
        if res is None:
            return ntt.intt(values, self.k, out=out)
        return ntt._into(res, out)

    def coeff_to_lagrange(self, coeffs: torch.Tensor) -> torch.Tensor:
        out = self._over_mesh(coeffs, self.k, False)
        return ntt.ntt(coeffs, self.k) if out is None else out

    def coeff_to_extended(self, coeffs: torch.Tensor, out_mont: bool = False,
                          out: torch.Tensor | None = None) -> torch.Tensor:
        """(..., n, 8) coefficients -> (..., ext_n, 8) coset values (the
        transform pads with zeros); in Montgomery form with `out_mont`;
        into `out` when given."""
        ek = self.extended_k
        res = self._over_mesh(coeffs, ek, False, self.G_COSET, out_mont)
        if res is None:
            return ntt.coset_ntt(coeffs, ek, self.G_COSET, out_mont, out=out)
        return ntt._into(res, out)

    def coeff_to_coset(self, coeffs: torch.Tensor, g: int,
                       out_mont: bool = False,
                       out: torch.Tensor | None = None) -> torch.Tensor:
        """(..., n, 8) coefficients -> their values on the size-n coset g*H
        (the coset-separated quotient's conversion), into `out` when
        given."""
        res = self._over_mesh(coeffs, self.k, False, g, out_mont)
        if res is None:
            return ntt.coset_ntt(coeffs, self.k, g, out_mont, out=out)
        return ntt._into(res, out)

    def coset_to_coeff(self, values: torch.Tensor, g: int,
                       in_mont: bool = False) -> torch.Tensor:
        """(..., n, 8) values on the size-n coset g*H (Montgomery form with
        `in_mont`) -> canonical coefficients c_d with sum_d c_d (g w^t)^d
        equal to them: the inverse of `coeff_to_coset`."""
        res = self._over_mesh(values, self.k, True, g, in_mont)
        if res is None:
            return ntt.coset_intt(values, self.k, g, in_mont)
        return res

    def extended_to_coeff(self, values: torch.Tensor,
                          in_mont: bool = False) -> torch.Tensor:
        ek = self.extended_k
        out = self._over_mesh(values, ek, True, self.G_COSET, in_mont)
        if out is None:
            out = ntt.coset_intt(values, ek, self.G_COSET, in_mont)
        return out

    @cached_property
    def zh_inv_extended(self) -> torch.Tensor:
        """1 / Z_H over the extended coset, (ext_n, 8); Z_H there has period
        extended_n / n."""
        period = self.extended_n // self.n
        g_n = pow(self.G_COSET, self.n, rc.FR)
        w_n = pow(self.extended_omega, self.n, rc.FR)
        vals, acc = [], g_n
        for _ in range(period):
            vals.append(rc.finv((acc - 1) % rc.FR, rc.FR))
            acc = acc * w_n % rc.FR
        return field.from_ints(FR, vals, self.device).repeat(self.n, 1)

    @cached_property
    def omega_pows_device(self) -> torch.Tensor:
        """(n, 8) [1, omega, omega^2, ...]."""
        return ntt.power_table(self.omega, self.n, self.device)

    @cached_property
    def omega_pows_mont(self) -> torch.Tensor:
        """The same table times R, for `field.mul_mont`."""
        return ntt.power_table(self.omega, self.n, self.device, mont=True)

