"""Number-theoretic transform over Fr, along axis -2 of (..., n, 8), and the
kernel ntt_pass.

Counterpart of halo2_zkcert_tpu/ops/ntt.py (an XLA program there).  `ntt`,
`intt`, `coset_ntt` and `coset_intt` wrap csrc/ntt.cu: on a CUDA tensor a
transform is one launch for every LOG_TILE stages (two at k = 17 or 19), each
a pass of butterflies over tiles in shared memory; the bit reversal, the zero
padding of a short input, the coset powers, 1/n and a conversion to or from
Montgomery form ride on the first pass's loads or the last pass's stores.  On
a CPU tensor they run the plain versions (`ntt_plain`, ...): the iterative
radix-2 decimation-in-time transform stage by stage, the bit reversal one
gather, every stage one K1 multiply by the stage twiddles plus one K1 add and
sub.  The result is the standard DFT X[i] = sum_j a[j] w^(ij) as canonical
residues, so it equals the reference's values whatever the internal order.

With H2T_NTT_MXU=1 (read at each call; default off) the four transforms go
to the four-step on the int8 tensor cores (ops/ntt_mxu.py) instead, on any
device, except while a prover mesh of more than one rank is active
(parallel/context.py), as in halo2_zkcert_tpu/ops/ntt.py:102-124.
"""
from __future__ import annotations

import math
import os

import torch

from ..utils import refcrypto as rc
from . import field, frops, kernels
from .field import FR

# stages a pass does on a tile of 2^LOG_TILE elements: NTT_LOG_TILE in
# csrc/ntt.cu
LOG_TILE = 10

_tables: dict = {}


def _bitrev(k: int, device) -> torch.Tensor:
    idx = torch.arange(1 << k, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev.to(device)


def power_table(base: int, n: int, device, mont: bool = False) -> torch.Tensor:
    """(n, 8) [1, base, base^2, ...] on `device`, cached; with `mont` every
    entry times R, the operand `field.mul_mont` wants."""
    key = ("pow", base % rc.FR, n, str(device), mont)
    t = _tables.get(key)
    if t is None:
        if mont:
            t = field.to_mont(FR, power_table(base, n, device))
        else:
            t = frops.powers(field.const(FR, base, device), n)
        _tables[key] = t
    return t


def _root(k: int, inverse: bool) -> int:
    w = rc.fr_root_of_unity(k)
    return pow(w, rc.FR - 2, rc.FR) if inverse else w


# ---------------------------------------------------------------------------
# plain versions: a launch of K1 (or its plain arithmetic) a stage
# ---------------------------------------------------------------------------

def _device_tables(k: int, inverse: bool, device):
    key = ("ntt", k, inverse, str(device))
    t = _tables.get(key)
    if t is None:
        half = power_table(_root(k, inverse), max(1, (1 << k) // 2), device)
        tws = [half[::1 << (k - s - 1)].contiguous() for s in range(k)]
        perm = _bitrev(k, device)
        n_inv = field.const(FR, pow(1 << k, rc.FR - 2, rc.FR), device)
        t = (perm, tws, n_inv)
        _tables[key] = t
    return t


def _pad(a: torch.Tensor, n: int) -> torch.Tensor:
    """Zero coefficients up to length n."""
    assert a.shape[-2] <= n, (a.shape, n)
    return torch.nn.functional.pad(a, (0, 0, 0, n - a.shape[-2]))


def _transform_plain(a: torch.Tensor, k: int, inverse: bool) -> torch.Tensor:
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


def ntt_plain(a: torch.Tensor, k: int) -> torch.Tensor:
    return _transform_plain(a, k, False)


def intt_plain(a: torch.Tensor, k: int) -> torch.Tensor:
    return _transform_plain(a, k, True)


def scale_by_powers(a: torch.Tensor, base: int, n: int) -> torch.Tensor:
    """a[..., i, :] *= base^i."""
    return field.mul(FR, a, power_table(base, n, a.device))


def coset_ntt_plain(a: torch.Tensor, k: int, g: int,
                    out_mont: bool = False) -> torch.Tensor:
    x = ntt_plain(scale_by_powers(_pad(a, 1 << k), g, 1 << k), k)
    return field.to_mont(FR, x) if out_mont else x


def coset_intt_plain(a: torch.Tensor, k: int, g: int,
                     in_mont: bool = False) -> torch.Tensor:
    x = intt_plain(field.from_mont(FR, a) if in_mont else a, k)
    return scale_by_powers(x, pow(g, rc.FR - 2, rc.FR), 1 << k)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def passes(k: int, log_tile: int | None = None) -> list:
    """The passes of a length-2^k transform over tiles of 2^log_tile
    elements (LOG_TILE unless given): (s0, t, a) = first stage, stages, and
    the log of how many neighbouring groups share a tile (csrc/bn254.cuh
    NttPass)."""
    log_tile = LOG_TILE if log_tile is None else log_tile
    out, s0 = [], 0
    while s0 < k or not out:
        t = min(k - s0, log_tile)
        out.append((s0, t, min(log_tile - t, s0)))
        s0 += max(t, 1)
    return out


def _twiddles(k: int, inverse: bool, device) -> torch.Tensor:
    """w^j * R for j < 2^(k-1) (one entry at k = 0), w the root of the
    transform or its inverse."""
    return power_table(_root(k, inverse), max(1, (1 << k) // 2), device,
                       mont=True)


def _scale_table(key: tuple, device, make) -> torch.Tensor:
    key = ("scale",) + key + (str(device),)
    t = _tables.get(key)
    if t is None:
        t = make().contiguous()
        _tables[key] = t
    return t


def run_passes(launch, a: torch.Tensor, k: int, tw: torch.Tensor, in_scale,
               out_scale, log_tile: int | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Drive `launch` (h2t_ntt_pass without its stream) through the passes
    of one transform of the columns `a` (..., n_in <= 2^k, 8), into `out`
    (a new tensor unless given: contiguous int32 (..., 2^k, 8) on a's
    device, not overlapping a)."""
    n, n_in = 1 << k, a.shape[-2]
    if n_in > n or a.shape[-1] != 8:
        raise ValueError(f"ntt: expected (..., n <= {n}, 8), got "
                         f"{tuple(a.shape)}")
    lead = a.shape[:-2]
    if out is None:
        out = torch.empty(lead + (n, 8), dtype=torch.int32, device=a.device)
    elif (out.shape != lead + (n, 8) or out.dtype != torch.int32
          or out.device != a.device or not out.is_contiguous()):
        raise ValueError(f"ntt: out must be contiguous int32 "
                         f"{tuple(lead + (n, 8))} on {a.device}")
    B = math.prod(lead)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def period(t):
        return 1 if t is None else t.shape[0]

    for s0, t, adj in passes(k, log_tile):
        rc_ = launch(a.data_ptr(), n_in, out.data_ptr(), B, k, s0, t, adj,
                     tw.data_ptr(), ptr(in_scale), period(in_scale),
                     ptr(out_scale), period(out_scale))
        kernels.check(rc_, "ntt")
    return out


def _transform(a: torch.Tensor, k: int, inverse: bool, in_scale=None,
               out_scale=None, out=None) -> torch.Tensor:
    a = a.contiguous()
    tw = _twiddles(k, inverse, a.device)
    tables = [t for t in (tw, in_scale, out_scale) if t is not None]
    kernels.require_cuda_int32("ntt", a, *tables)
    lib = kernels.lib("ntt")
    stream = kernels.stream_ptr(a.device)

    def launch(*args):
        kernels.launches["ntt"] += 1
        return lib.h2t_ntt_pass(*args, stream)

    return run_passes(launch, a, k, tw, in_scale, out_scale, out=out)


def _mxu():
    """ops/ntt_mxu when H2T_NTT_MXU=1 and no mesh of several ranks is
    active, else None."""
    if os.environ.get("H2T_NTT_MXU", "0") != "1":
        return None
    from ..parallel.context import multi_rank
    if multi_rank() is not None:
        return None
    from . import ntt_mxu
    return ntt_mxu


def ntt(a: torch.Tensor, k: int) -> torch.Tensor:
    """Forward NTT: values X[i] = sum_j a[j] w^(ij)."""
    if (mxu := _mxu()) is not None:
        return mxu.ntt(a, k)
    if a.device.type == "cpu":
        return ntt_plain(a, k)
    return _transform(a, k, False)


def _into(res: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """`res` copied into `out` where one is given: the routes that do not
    write in place (the plain versions, the four-step)."""
    if out is None:
        return res
    out.copy_(res)
    return out


def intt(a: torch.Tensor, k: int, out: torch.Tensor | None = None
         ) -> torch.Tensor:
    """Inverse NTT, including the 1/n scaling; into `out` when given."""
    if (mxu := _mxu()) is not None:
        return _into(mxu.intt(a, k), out)
    if a.device.type == "cpu":
        return _into(intt_plain(a, k), out)
    n_inv = _scale_table(("n_inv", k), a.device, lambda: field.const_mont(
        FR, pow(1 << k, rc.FR - 2, rc.FR), a.device)[None])
    return _transform(a, k, True, out_scale=n_inv, out=out)


def coset_ntt(a: torch.Tensor, k: int, g: int, out_mont: bool = False,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Evaluate coefficients `a` on the coset g*H; an `a` shorter than 2^k
    stands for its zero-padded self.  With `out_mont` the values leave in
    Montgomery form (x * R), at no cost: the transform is linear and the
    table of powers carries the factor.  Into `out` when given (a slice of
    a larger buffer: the coset-separated quotient's leaves)."""
    if (mxu := _mxu()) is not None:
        return _into(mxu.coset_ntt(a, k, g, out_mont), out)
    if a.device.type == "cpu":
        return _into(coset_ntt_plain(a, k, g, out_mont), out)

    def make():
        t = power_table(g, 1 << k, a.device, mont=True)        # g^j R
        return field.to_mont(FR, t) if out_mont else t          # g^j R^2

    return _transform(a, k, False, in_scale=_scale_table(
        ("coset", k, g % rc.FR, out_mont), a.device, make), out=out)


def coset_intt(a: torch.Tensor, k: int, g: int,
               in_mont: bool = False) -> torch.Tensor:
    """Interpolate values on the coset g*H back to coefficients.  With
    `in_mont` the values arrive in Montgomery form and the coefficients
    still leave canonical."""
    if (mxu := _mxu()) is not None:
        return mxu.coset_intt(a, k, g, in_mont)
    if a.device.type == "cpu":
        return coset_intt_plain(a, k, g, in_mont)

    def make():
        t = field.mul_const(                                    # g^-i / n
            FR, power_table(pow(g, rc.FR - 2, rc.FR), 1 << k, a.device),
            pow(1 << k, rc.FR - 2, rc.FR))
        return t if in_mont else field.to_mont(FR, t)

    return _transform(a, k, True, out_scale=_scale_table(
        ("coset_inv", k, g % rc.FR, in_mont), a.device, make))
