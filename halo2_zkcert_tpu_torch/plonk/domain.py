"""Evaluation domain: a 2^k subgroup H = <omega> of Fr*, its extended coset
g * H_ext of size 2^extended_k, and Z_H(X) = X^n - 1.

Counterpart of halo2_zkcert_tpu/plonk/domain.py; device tables are built on
the domain's `device` and cached there.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import torch

from ..ops import field, ntt
from ..ops.field import FR
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

    def lagrange_to_coeff(self, values: torch.Tensor) -> torch.Tensor:
        return ntt.intt(values, self.k)

    def coeff_to_lagrange(self, coeffs: torch.Tensor) -> torch.Tensor:
        return ntt.ntt(coeffs, self.k)

    def coeff_to_extended(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(..., n, 8) coefficients -> (..., ext_n, 8) coset values."""
        pad = self.extended_n - coeffs.shape[-2]
        if pad:
            coeffs = torch.nn.functional.pad(coeffs, (0, 0, 0, pad))
        return ntt.coset_ntt(coeffs, self.extended_k, self.G_COSET)

    def extended_to_coeff(self, values: torch.Tensor) -> torch.Tensor:
        return ntt.coset_intt(values, self.extended_k, self.G_COSET)

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

