"""Number-theoretic transform over Fr, along axis -2 of (..., n, 8).

Counterpart of halo2_zkcert_tpu/ops/ntt.py (an XLA program there): an
iterative radix-2 decimation-in-time transform, the bit-reversal one gather,
every stage one K1 multiply by the stage twiddles plus one K1 add and sub.
The result is the standard DFT X[i] = sum_j a[j] w^(ij), so it equals the
reference's values whatever the internal order.
"""
from __future__ import annotations

import torch

from ..utils import refcrypto as rc
from . import field, frops
from .field import FR

_tables: dict = {}


def _bitrev(k: int, device) -> torch.Tensor:
    idx = torch.arange(1 << k, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev.to(device)


def power_table(base: int, n: int, device) -> torch.Tensor:
    """(n, 8) [1, base, base^2, ...] on `device`, cached."""
    key = ("pow", base % rc.FR, n, str(device))
    t = _tables.get(key)
    if t is None:
        t = frops.powers(field.const(FR, base, device), n)
        _tables[key] = t
    return t


def _device_tables(k: int, inverse: bool, device):
    key = ("ntt", k, inverse, str(device))
    t = _tables.get(key)
    if t is None:
        w = rc.fr_root_of_unity(k)
        if inverse:
            w = pow(w, rc.FR - 2, rc.FR)
        half = power_table(w, max(1, (1 << k) // 2), device)  # w^j, j < n/2
        tws = [half[::1 << (k - s - 1)].contiguous() for s in range(k)]
        perm = _bitrev(k, device)
        n_inv = field.const(FR, pow(1 << k, rc.FR - 2, rc.FR), device)
        t = (perm, tws, n_inv)
        _tables[key] = t
    return t


def _transform(a: torch.Tensor, k: int, inverse: bool) -> torch.Tensor:
    n = 1 << k
    assert a.shape[-2] == n, (a.shape, k)
    perm, tws, n_inv = _device_tables(k, inverse, a.device)
    lead = a.shape[:-2]
    x = a.index_select(-2, perm)
    for s in range(k):
        m = 1 << s
        x = x.reshape(lead + (n // (2 * m), 2, m, 8))
        e, o = x[..., 0, :, :], x[..., 1, :, :]
        t = field.mul(FR, o, tws[s])
        x = torch.stack((field.add(FR, e, t), field.sub(FR, e, t)), dim=-3)
    x = x.reshape(lead + (n, 8))
    if inverse:
        x = field.mul(FR, x, n_inv)
    return x


def ntt(a: torch.Tensor, k: int) -> torch.Tensor:
    """Forward NTT: values X[i] = sum_j a[j] w^(ij)."""
    return _transform(a, k, False)


def intt(a: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse NTT, including the 1/n scaling."""
    return _transform(a, k, True)


def scale_by_powers(a: torch.Tensor, base: int, n: int) -> torch.Tensor:
    """a[..., i, :] *= base^i."""
    return field.mul(FR, a, power_table(base, n, a.device))


def coset_ntt(a: torch.Tensor, k: int, g: int) -> torch.Tensor:
    """Evaluate coefficients `a` on the coset g*H."""
    return ntt(scale_by_powers(a, g, 1 << k), k)


def coset_intt(a: torch.Tensor, k: int, g: int) -> torch.Tensor:
    """Interpolate values on the coset g*H back to coefficients."""
    return scale_by_powers(intt(a, k), pow(g, rc.FR - 2, rc.FR), 1 << k)
