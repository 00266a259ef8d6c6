"""PLONKish prover: create_proof.

Counterpart of halo2_zkcert_tpu/plonk/prover.py: phase advice commits ->
lookup permute and commit -> permutation and lookup grand products ->
vanishing random poly -> quotient -> barycentric evaluations at x -> SHPLONK
multiopen.  Every O(n) step is a device op on the proving key's device; the
Fiat-Shamir transcript and per-poly scalar glue stay on the host.  Given the
same pk, witness, instances and blinding seed the proof bytes equal the
reference's, whichever path below the proof takes.

The quotient takes one of two paths, chosen at each call:
  one-shot         (`_Quotient`) the pk's fixed, sigma and aux columns kept
                   on the extended coset, the fresh columns transformed onto
                   it, the forest as one K4 launch over all ext_n rows;
  coset-separated  (`_QuotientCoset`, the reference's `_quotient_fn_coset`)
                   where the one-shot leaves (`leaf_bytes`: leaves x ext_n x
                   32 B) pass the budget (`ext_budget_bytes`).  Every
                   rotation is a multiple of the stride ext_n / n, so the
                   quotient splits into one size-n pass a coset g w_ext^c H:
                   the leaves converted onto it into one reused (L, n, 8)
                   buffer and K4 on the stride-1 tape; the pieces come back
                   through a coset inverse transform a coset and a stride x
                   stride inverse DFT across them.  The device then holds one
                   coset's leaves and the fresh columns' coefficient forms,
                   nothing ext_n rows long.
From H2T_U8_MIN_N rows on, the big-domain residency (the reference's
`_shrink`; its u8 form has no counterpart: 8 canonical words are already the
size of its 33 bytes): the grand products one Z at a time; the Lagrange
window table parked through the quotient and the monomial one after the h
commitments (`ParamsKZG.park_fixed_base`: read back from its file, or from
the host); the key's Lagrange columns on the host through the quotient
(`ProvingKey.park_lagrange`; its coefficient forms stay on the card, where
every coset reads them); on the coset path the witness columns on the host
from the end of the coefficient staging to the evaluations (not under
H2T_SELFCHECK, as in the reference).

The big-domain knobs: the reference's names and meanings, read at each call.
The port's defaults keep every circuit it has driven on the one-shot path and
its residency; the reference's are set for a 16 GB TPU:
  H2T_EXT_BUDGET_BYTES  unset: the device's memory over
                        ONE_SHOT_PEAK_PER_LEAF_BYTE (35.2 GiB on an 80 GB
                        H100; reference 2 GiB of its 132-byte int32 limbs):
                        one-shot leaf bytes above it take the coset path.
                        The k=20 aggregation's 157 leaves over 2^22 rows are
                        19.6 GiB.
  H2T_U8_MIN_N          2^21 (reference 2^19): the big-domain residency
                        from this many rows on.
The reference's H2T_NTT_GROUP_BYTES and H2T_EVAL_GROUP_BYTES bound its
radix-2 program's temporaries and its evaluation batches; ntt.cu writes each
transform straight into its slice of the leaves with no scratch, and the
evaluations go 16 pairs a batch, so the port has neither.
The reference's H2T_MULTIOPEN=eager (a device op at a time in the multiopen,
for big n) has no switch here: `open_shplonk` always works that way.

The reference's debugging knobs, read from the environment at each call
and off by default; they print the reference's lines and change no byte:
  H2T_SELFCHECK  1: the verifier's h(x) recomputed from the claimed
                 evaluations on the host (`_selfcheck_quotient_identity`);
                 2: and advice0, sigma0 and h evaluated at x on the host
                 (barycentric), the collapsed h by Horner; 3: and the grand
                 products' recurrences over H (K1 residuals on the device);
                 4, 5: and h over 8 rows of K4's launch (the extended
                 domain, or the first coset) recomputed with Python ints
                 from K4's own leaves (`_oracle_quotient_window`).
                 The verdicts also land in LAST_SELFCHECK.
  H2T_EVAL_MODE  coeff: the evaluations from coefficient forms (inverse
                 transform, then `frops.poly_eval_many`).
  H2T_PROFILE    the stage ticks `[prove] <stage>: <s>` (and keygen's).
  H2T_PROFILE2   the witness passes, the quotient's sub-stages and the
                 commitments (plonk/kzg.py).
Both print from the span recorder (utils/trace.py), which records a proof's
spans while either is set or torch's profiler collects: `prove`, its six
stages (the readings of `LAST_STAGE_TIMES`), the witness phases, the
blinding draws and the quotient's sub-stages.
"""
from __future__ import annotations

import os

import torch

from ..ops import field, frops, ntt
from ..ops.field import FR
from ..utils import refcrypto as rc
from ..utils import trace
from . import expression as ex
from .assignment import BlindingRng
from .cs import ADVICE, DELTA, FIXED, INSTANCE
from .keygen import ProvingKey
from .kzg import ParamsKZG, commit_many, commit_many_lagrange
from .quotient import AUX, compile_tape, leaf_layout, quotient_forest
from .shplonk import ProverQuery, open_shplonk

# the big-domain knobs' defaults (module docstring).  A one-shot proof's peak
# device memory over its leaf bytes: 47.32 GB for the k=20 aggregation's
# 21.07 GB of leaves on an H100 (chip_smoke.py phase 10, PERF.md).
ONE_SHOT_PEAK_PER_LEAF_BYTE = 2.25
U8_MIN_N = 1 << 21
# Per-stage wall seconds of the LAST create_proof call (device-synchronized
# at each stage boundary).
LAST_STAGE_TIMES: dict = {}
# The LAST create_proof call's self-check verdicts (H2T_SELFCHECK): the
# printed label -> "OK", "MISMATCH" or "VIOLATED".
LAST_SELFCHECK: dict = {}


def _verdict(tag: str, label: str, ok: bool, bad: str, line: str) -> None:
    LAST_SELFCHECK[label] = "OK" if ok else bad
    print(f"  [{tag}] {line}", flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def instance_lagrange(vals: list, n: int, device) -> torch.Tensor:
    out = torch.zeros((n, 8), dtype=torch.int32, device=device)
    out[:len(vals)] = field.from_ints(FR, vals, device)
    return out


def _eval_expr_lagrange(e: ex.Expr, n: int, advice, fixed, instance,
                        challenges, device):
    """An expression over the original Lagrange domain (device)."""
    def c(v):
        return field.const(FR, v, device)

    return ex.evaluate(
        e,
        constant=lambda v: c(v).expand(n, 8),
        fixed=lambda i, r: torch.roll(fixed[i], -r, dims=0),
        advice=lambda i, r: torch.roll(advice[i], -r, dims=0),
        instance=lambda i, r: torch.roll(instance[i], -r, dims=0),
        challenge=lambda i: c(challenges[i]).expand(n, 8),
        add=lambda a, b: field.add(FR, a, b),
        mul=lambda a, b: field.mul(FR, a, b),
        scale=lambda a, s: field.mul_const(FR, a, s),
    )


def _commit_mixed(params: ParamsKZG, cols: list, bits: list,
                  blind_lo: int) -> list:
    """Commit columns with per-column value-bit hints, keeping their order:
    columns with a bound (bits[i] not None) go through the bounded-window
    fixed-base path grouped by bound, the rest through the full path."""
    pts = [None] * len(cols)
    groups: dict = {}
    for i, b in enumerate(bits):
        groups.setdefault(b, []).append(i)
    for b, idxs in groups.items():
        hint = {} if b is None else dict(value_bits=b, blind_lo=blind_lo)
        for i, pt in zip(idxs, commit_many_lagrange(
                params, [cols[i] for i in idxs], **hint)):
            pts[i] = pt
    return pts


def _compress(exprs, theta: int, leaf_eval) -> torch.Tensor:
    """theta-fold: acc = acc * theta + value (halo2 lookup compression)."""
    acc = None
    for e in exprs:
        v = leaf_eval(e)
        acc = v if acc is None else field.add(
            FR, field.mul_const(FR, acc, theta), v)
    return acc


def _gp_terms(pk: ProvingKey, perm_vals, lookups, beta: int, gamma: int):
    """Each Z's numerator and denominator columns, in commitment order:
    the permutation chunks, then the lookups."""
    csys = pk.vk.cs
    dom = pk.domain()
    dev = pk.device
    chunk_len = csys.permutation_chunk_len()
    nperm = len(csys.permutation_columns)
    beta_t, gamma_t = field.const(FR, beta, dev), field.const(FR, gamma, dev)
    ob = field.mul_const(FR, dom.omega_pows_device, beta)
    for ci in range(csys.num_permutation_chunks()):
        num = den = None
        for gpos in range(ci * chunk_len, min(nperm, (ci + 1) * chunk_len)):
            v = perm_vals[gpos]
            t_num = field.add(FR, field.add(
                FR, v, field.mul_const(FR, ob, pow(DELTA, gpos, rc.FR))),
                gamma_t)
            t_den = field.add(FR, field.add(
                FR, v, field.mul_const(FR, pk.sigma_lagrange[gpos], beta)),
                gamma_t)
            num = t_num if num is None else field.mul(FR, num, t_num)
            den = t_den if den is None else field.mul(FR, den, t_den)
        yield num, den
    for lk in lookups:
        yield (field.mul(FR, field.add(FR, lk["a"], beta_t),
                         field.add(FR, lk["s"], gamma_t)),
               field.mul(FR, field.add(FR, lk["a_perm"], beta_t),
                         field.add(FR, lk["s_perm"], gamma_t)))


def _units(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """(m, n, 8) numerators and denominators -> each Z before chaining:
    the prefix products of [1, num/den ...], one batched inversion."""
    ratio = field.mul(FR, num, frops.batch_inv(den.reshape(-1, 8))
                      .reshape(den.shape))
    one = field.one(num.device, (num.shape[0], 1))
    return frops.prefix_product_batched(torch.cat((one, ratio[:, :-1]),
                                                  dim=1))


def _grand_products(pk: ProvingKey, perm_vals, lookups, beta: int,
                    gamma: int, blinds, streamed: bool = False,
                    keep: bool = True) -> tuple:
    """Every permutation-chunk Z (chained across chunks) and every lookup
    Z, blinding rows set: all in one batched inversion and prefix product,
    or with `streamed` one Z at a time (the big-domain residency: one Z's
    columns live at once, the reference's streaming pass).  Returns (the
    Zs, their numerators and denominators: stacked (Z count, n, 8), or
    lists when streamed, None without Zs or, streamed, without `keep`)."""
    csys = pk.vk.cs
    n = pk.domain().n
    bf = csys.blinding_factors()
    u_row = n - bf - 1
    num_chunks = csys.num_permutation_chunks()
    terms = _gp_terms(pk, perm_vals, lookups, beta, gamma)
    if streamed:
        nums, dens = ([], []) if keep else (None, None)

        def units():
            for num, den in terms:
                if keep:
                    nums.append(num)
                    dens.append(den)
                yield _units(num[None], den[None])[0]
        zs = units()
    else:
        pairs = list(terms)
        if not pairs:
            return [], None, None
        nums = torch.stack([p[0] for p in pairs])
        dens = torch.stack([p[1] for p in pairs])
        del pairs
        zs = _units(nums, dens)
    outs = []
    start = None
    for i, z in enumerate(zs):
        if i < num_chunks and start is not None:
            z = field.mul(FR, z, start)
        if i < num_chunks:
            start = z[u_row].clone()
        z = z.clone()
        z[n - bf:] = blinds[i]
        outs.append(z)
    if not outs:
        return [], None, None
    return outs, nums, dens


def _selfcheck_grand_products(perm_zs, lookup_zs, num, den, u_row) -> None:
    """H2T_SELFCHECK=3: each Z's recurrence Z(w x) den(x) = Z(x) num(x) on
    the rows before u_row, each chunk's start at the last chunk's u_row,
    and the last chunk's Z(u_row) = 1 (residuals on the device)."""
    def check(resid, what):
        ok = bool((resid == 0).all())
        _verdict("selfcheck3", what, ok, "VIOLATED",
                 f"{what}: {'OK' if ok else 'VIOLATED'}")

    def recurrence(i, z):
        return field.sub(FR, field.mul(FR, torch.roll(z, -1, dims=0), den[i]),
                         field.mul(FR, z, num[i]))[:u_row]

    for ci, z in enumerate(perm_zs):
        check(recurrence(ci, z), f"perm_z{ci} recurrence")
        if ci:
            check(field.sub(FR, z[:1], perm_zs[ci - 1][u_row:u_row + 1]),
                  f"perm_z{ci} chain start")
    if perm_zs:
        check(field.sub(FR, perm_zs[-1][u_row:u_row + 1],
                        field.one(perm_zs[-1].device, (1,))),
              "perm_z last == 1 at u_row")
    for li, z in enumerate(lookup_zs):
        check(recurrence(len(perm_zs) + li, z), f"lookup{li}_z recurrence")


def _env_int(name: str, default):
    v = os.environ.get(name)
    return default if v is None else int(v)


def leaf_bytes(csys, ext_n: int) -> int:
    """Bytes of the one-shot quotient's leaves: every leaf column over the
    extended domain, 8 words a value."""
    return len(leaf_layout(csys)) * ext_n * 32


def device_memory(device) -> int:
    """Bytes of memory on `device`: a card's total, or the host's."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def ext_budget_bytes(device) -> int:
    """H2T_EXT_BUDGET_BYTES, else the most one-shot leaf bytes whose proof
    fits `device`'s memory."""
    return _env_int("H2T_EXT_BUDGET_BYTES", int(
        device_memory(device) / ONE_SHOT_PEAK_PER_LEAF_BYTE))


def coset_quotient_wanted(csys, ext_n: int, device) -> bool:
    """Whether a proof on `device` takes the coset-separated quotient now."""
    return leaf_bytes(csys, ext_n) > ext_budget_bytes(device)


def big_domain(n: int) -> bool:
    """Whether a proof over n rows takes the big-domain residency now
    (H2T_U8_MIN_N)."""
    return n >= _env_int("H2T_U8_MIN_N", U8_MIN_N)


def _stage(fn, cols: list, out: torch.Tensor) -> torch.Tensor:
    """fn(col, out=out[i]) for each column of the list: no stacked copy."""
    for i, col in enumerate(cols):
        fn(col, out=out[i])
    return out


def _aux_basis(dom, u_row: int, device) -> torch.Tensor:
    """l0, l_last and l_blind in coefficient form, (3, n, 8)."""
    basis = torch.zeros((3, dom.n, 8), dtype=torch.int32, device=device)
    basis[0, 0, 0] = 1
    basis[1, u_row, 0] = 1
    basis[2, u_row + 1:, 0] = 1
    return dom.lagrange_to_coeff(basis)


class _Quotient:
    """Per-pk one-shot quotient pipeline: the pk's extended columns (kept in
    Montgomery form, what K4 reads) and the tape are built once; each proof
    transforms its fresh columns onto the coset in that form, runs K4 over
    the whole extended domain and hands its result to the inverse transform
    as it is."""

    def __init__(self, pk: ProvingKey):
        csys = pk.vk.cs
        dom = pk.domain()
        n, ext_n, dev = dom.n, dom.extended_n, pk.device
        self.dom, self.csys = dom, csys
        self.stride = ext_n // n
        self.tape = compile_tape(csys, n, ext_n)
        self.layout = leaf_layout(csys)
        self.u_row = n - csys.blinding_factors() - 1
        nf, ns = pk.fixed_coeff.shape[0], pk.sigma_coeff.shape[0]
        self.static = torch.empty((nf + ns + len(AUX), ext_n, 8),
                                  dtype=torch.int32, device=dev)
        assert self.static.shape[0] == self.layout[("aux", AUX[-1])] + 1
        parts = self.static.split([nf, ns, 3, 2])

        def ext(c, out):
            return dom.coeff_to_extended(c, True, out=out)

        ext(pk.fixed_coeff, parts[0])
        ext(pk.sigma_coeff, parts[1])
        ext(_aux_basis(dom, self.u_row, dev), parts[2])
        ident = field.mul_const(FR, ntt.power_table(dom.extended_omega, ext_n,
                                                    dev), dom.G_COSET)
        parts[3].copy_(field.to_mont(FR, torch.stack((ident,
                                                      dom.zh_inv_extended))))

    def __call__(self, pk: ProvingKey, fresh: list, chal: torch.Tensor,
                 on_staged=None):
        """fresh: the (n, 8) advice, instance, permutation Z, lookup Z,
        permuted input and permuted table columns (leaf_layout order).
        Returns the quotient pieces (qd, n, 8) in coefficient form."""
        dom = self.dom
        n, ext_n = dom.n, dom.extended_n
        lag_cols = torch.stack(fresh)
        C = lag_cols.shape[0]
        tick2 = trace.Ticks("quot", "H2T_PROFILE2", lag_cols.device)
        coeff = dom.lagrange_to_coeff(lag_cols)
        del lag_cols
        tick2(f"lag2coeff x{C}")
        leaves = torch.empty((self.static.shape[0] + C, ext_n, 8),
                             dtype=torch.int32, device=coeff.device)
        dom.coeff_to_extended(coeff, True,
                              out=leaves[self.static.shape[0]:])
        del coeff                              # not held through K4
        leaves[:self.static.shape[0]] = self.static
        tick2(f"coeff2ext x{C}")
        h = quotient_forest(leaves, self.tape.const_table(chal), self.tape)
        tick2("pointwise")
        if os.environ.get("H2T_SELFCHECK") in ("4", "5"):
            _oracle_quotient_window(self, leaves, field.to_ints(chal), h)
        del leaves
        coeffs = dom.extended_to_coeff(h, True)
        tick2("h coset_intt")
        return coeffs.reshape(-1, n, 8)[:dom.quotient_degree]


class CosetSplit:
    """The cosets g_c H, g_c = g w_ext^c, c < s = ext_n / n, into which a
    domain's extended coset falls, and the way back from values on them to
    the quotient's pieces.  With b'_c = coset_intt(h_c, g_c), which is
    sum_j a_{d + jn} (g^n)^j zeta^(cj) (zeta = w_ext^n),
        a_{d + jn} = (g^n)^(-j) / s * sum_c zeta^(-cj) b'_c[d]:
    a coset inverse transform a coset, then K1 products and sums."""

    def __init__(self, dom):
        n, stride = dom.n, dom.extended_n // dom.n
        self.dom = dom
        self.g_cosets = [dom.G_COSET * pow(dom.extended_omega, c, rc.FR)
                         % rc.FR for c in range(stride)]
        s_inv = rc.finv(pow(dom.G_COSET, n, rc.FR), rc.FR)
        zeta_inv = rc.finv(pow(dom.extended_omega, n, rc.FR), rc.FR)
        inv_stride = rc.finv(stride, rc.FR)
        # weights[j][c]: the weight of b'_c in piece j
        self.weights = [[pow(s_inv, j, rc.FR) * pow(zeta_inv, c * j, rc.FR)
                         % rc.FR * inv_stride % rc.FR for c in range(stride)]
                        for j in range(dom.quotient_degree)]

    def add(self, pieces, c: int, h_c: torch.Tensor) -> torch.Tensor:
        """Coset c's values h_c (n, 8), Montgomery form, added into the
        pieces (qd, n, 8) so far (None before coset 0)."""
        b_c = self.dom.coset_to_coeff(h_c, self.g_cosets[c], True)
        if pieces is None:
            pieces = torch.empty((len(self.weights),) + b_c.shape,
                                 dtype=torch.int32, device=b_c.device)
        for j, w in enumerate(self.weights):
            term = field.mul_const(FR, b_c, w[c])
            pieces[j] = term if c == 0 else field.add(FR, pieces[j], term)
        return pieces


class _QuotientCoset:
    """Per-pk coset-separated quotient, the counterpart of the reference's
    `_quotient_fn_coset`.  Every rotation of the forest is a multiple of
    the stride ext_n / n, so the extended evaluation splits over the cosets
    of `CosetSplit`: for each, the leaves are converted onto g_c H (n rows)
    into ONE (L, n, 8) buffer, reused across cosets, K4 runs the stride-1
    tape over them (Z_H is the constant g_c^n - 1 there), and its values go
    into the pieces at once.  Nothing ext_n rows long is made."""

    def __init__(self, pk: ProvingKey):
        csys = pk.vk.cs
        dom = pk.domain()
        self.dom, self.csys = dom, csys
        self.stride = 1
        self.tape = compile_tape(csys, dom.n, dom.n)
        self.layout = leaf_layout(csys)
        self.u_row = dom.n - csys.blinding_factors() - 1
        self.aux_coeff = _aux_basis(dom, self.u_row, pk.device)
        self.split = CosetSplit(dom)

    def __call__(self, pk: ProvingKey, fresh: list, chal: torch.Tensor,
                 on_staged=None):
        """As `_Quotient.__call__`.  The fresh columns are staged in
        coefficient form first; then `fresh` is emptied and `on_staged()`
        called, so the caller may take its own copies off the device."""
        dom, lay = self.dom, self.layout
        n = dom.n
        dev = chal.device
        C = len(fresh)
        tick2 = trace.Ticks("quot/coset", "H2T_PROFILE2", dev)
        staged = _stage(dom.lagrange_to_coeff, fresh, torch.empty(
            (C, n, 8), dtype=torch.int32, device=dev))
        fresh.clear()
        if on_staged is not None:
            on_staged()
        tick2(f"lag2coeff x{C}")

        nf, ns = pk.fixed_coeff.shape[0], pk.sigma_coeff.shape[0]
        aux0 = lay[("aux", AUX[0])]
        fresh0 = lay[("aux", AUX[-1])] + 1
        leaves = torch.empty((fresh0 + C, n, 8), dtype=torch.int32,
                             device=dev)
        consts = self.tape.const_table(chal)
        pieces = None
        for c, g_c in enumerate(self.split.g_cosets):
            def conv(cols, out):
                return dom.coeff_to_coset(cols, g_c, True, out=out)

            conv(pk.fixed_coeff, leaves[:nf])
            conv(pk.sigma_coeff, leaves[nf:nf + ns])
            conv(self.aux_coeff, leaves[aux0:aux0 + 3])
            # omega^i g_c and 1 / (g_c^n - 1), Montgomery form
            leaves[lay[("aux", "ident")]] = field.mul_const(
                FR, dom.omega_pows_mont, g_c)
            leaves[lay[("aux", "zh_inv")]] = field.const_mont(
                FR, rc.finv((pow(g_c, n, rc.FR) - 1) % rc.FR, rc.FR), dev)
            conv(staged, leaves[fresh0:])
            h_c = quotient_forest(leaves, consts, self.tape)
            if c == 0 and os.environ.get("H2T_SELFCHECK") in ("4", "5"):
                _oracle_quotient_window(self, leaves, field.to_ints(chal),
                                        h_c)
            pieces = self.split.add(pieces, c, h_c)
            tick2(f"coset {c}")
        return pieces


def _oracle_quotient_window(quot, leaves: torch.Tensor,
                            chal: list, h: torch.Tensor, s: int = 17,
                            W: int = 8) -> None:
    """H2T_SELFCHECK=4, 5: h over the rows [s, s + W) of K4's launch (the
    extended domain, or a coset) recomputed with Python ints from K4's own
    leaves (Montgomery form), read at each rotation's stride, against K4's
    output there: an exact oracle for the tape and the kernel."""
    csys, lay = quot.csys, quot.layout
    rows, stride = leaves.shape[1], quot.stride
    u_row = quot.u_row
    chunk_len = csys.permutation_chunk_len()
    perm_cols = csys.permutation_columns
    chunks = [perm_cols[i:i + chunk_len]
              for i in range(0, len(perm_cols), chunk_len)]
    r_inv = rc.finv(FR.r, rc.FR)
    theta_i, beta_i, gamma_i, y_i = chal[:4]

    def rows_of(col, r=0):
        idx = torch.arange(s + r * stride, s + W + r * stride) % rows
        return [v * r_inv % rc.FR
                for v in field.to_ints(col[idx.to(col.device)])]

    def fetch(tag, i, r=0):
        return rows_of(leaves[lay[(tag, i)]], r)

    def ew(op, a, b):
        return [op(x, y) % rc.FR for x, y in zip(a, b)]

    def fadd(a, b):
        return ew(lambda x, y: x + y, a, b)

    def fsub(a, b):
        return ew(lambda x, y: x - y, a, b)

    def fmul(a, b):
        return ew(lambda x, y: x * y, a, b)

    def bc(v):
        return [v % rc.FR] * W

    def ext_leaf(e):
        return ex.evaluate(
            e,
            constant=bc,
            fixed=lambda i, r: fetch("f", i, r),
            advice=lambda i, r: fetch("a", i, r),
            instance=lambda i, r: fetch("i", i, r),
            challenge=lambda i: bc(chal[4 + i]),
            add=fadd, mul=fmul,
            scale=lambda a, sc: fmul(a, bc(sc)),
        )

    l0_v, llast_v, lblind_v, ident_v = (fetch("aux", a) for a in
                                        ("l0", "llast", "lblind", "ident"))
    one_v = bc(1)
    active_v = fsub(one_v, fadd(llast_v, lblind_v))
    h_acc = None

    def acc(term):
        nonlocal h_acc
        h_acc = term if h_acc is None else fadd(fmul(h_acc, bc(y_i)), term)

    for _, g in csys.gates:
        acc(ext_leaf(g))
    if chunks:
        pz = [fetch("permz", c) for c in range(len(chunks))]
        pz_next = [fetch("permz", c, 1) for c in range(len(chunks))]
        acc(fmul(l0_v, fsub(one_v, pz[0])))
        acc(fmul(llast_v, fsub(fmul(pz[-1], pz[-1]), pz[-1])))
        for c in range(1, len(chunks)):
            acc(fmul(l0_v, fsub(pz[c], fetch("permz", c - 1, u_row))))
        for ci, chunk in enumerate(chunks):
            left, right = pz_next[ci], pz[ci]
            for pos, col in enumerate(chunk):
                gpos = ci * chunk_len + pos
                v = fetch({ADVICE: "a", INSTANCE: "i", FIXED: "f"}[col.kind],
                          col.index)
                sig = fetch("sigma", gpos)
                left = fmul(left, fadd(fadd(v, fmul(sig, bc(beta_i))),
                                       bc(gamma_i)))
                right = fmul(right, fadd(fadd(
                    v, fmul(ident_v, bc(beta_i * pow(DELTA, gpos, rc.FR)))),
                    bc(gamma_i)))
            acc(fmul(active_v, fsub(left, right)))
    for li, lk in enumerate(csys.lookups):
        z_v, a_v, s_v = (fetch(tag, li) for tag in ("lkz", "lka", "lks"))
        zn_v = fetch("lkz", li, 1)
        ap_v = fetch("lka", li, -1)
        a_comp = s_comp = None
        for p_in, p_tab in lk.pairs:
            v = ext_leaf(p_in)
            a_comp = v if a_comp is None else fadd(fmul(a_comp, bc(theta_i)),
                                                   v)
        for p_in, p_tab in lk.pairs:
            v = ext_leaf(p_tab)
            s_comp = v if s_comp is None else fadd(fmul(s_comp, bc(theta_i)),
                                                   v)
        acc(fmul(l0_v, fsub(one_v, z_v)))
        acc(fmul(llast_v, fsub(fmul(z_v, z_v), z_v)))
        lhs = fmul(fmul(zn_v, fadd(a_v, bc(beta_i))), fadd(s_v, bc(gamma_i)))
        rhs = fmul(fmul(z_v, fadd(a_comp, bc(beta_i))),
                   fadd(s_comp, bc(gamma_i)))
        acc(fmul(active_v, fsub(lhs, rhs)))
        acc(fmul(l0_v, fsub(a_v, s_v)))
        acc(fmul(fmul(active_v, fsub(a_v, s_v)), fsub(a_v, ap_v)))

    want = fmul(h_acc, fetch("aux", "zh_inv"))
    got = rows_of(h)
    bad = [i for i in range(W) if want[i] != got[i]]
    if bad:
        line = (f"QUOTIENT WINDOW MISMATCH rows {s}+{bad}: want "
                f"{want[bad[0]]:#x} got {got[bad[0]]:#x}")
    else:
        line = f"quotient window rows [{s},{s + W}): OK"
    _verdict("selfcheck4", "quotient window", not bad, "MISMATCH", line)
    if os.environ.get("H2T_SELFCHECK") == "5":
        print("  [selfcheck5] (conversion spot-check runs in create_proof)",
              flush=True)


def quotient_pipeline(pk: ProvingKey):
    """The quotient pipeline a proof with `pk` takes now, kept on the pk:
    the coset-separated one where `coset_quotient_wanted`, else the
    one-shot one.  The one-shot one is never built on the coset path, and
    one built before is dropped with its extended columns."""
    coset = coset_quotient_wanted(pk.vk.cs, pk.domain().extended_n,
                                  pk.device)
    key = "_quotient_coset" if coset else "_quotient"
    if coset:
        pk.__dict__.pop("_quotient", None)
    q = pk.__dict__.get(key)
    if q is None:
        q = (_QuotientCoset if coset else _Quotient)(pk)
        pk.__dict__[key] = q
    return q


def _eval_barycentric(dom, values: dict, pairs: list) -> list:
    """Each (name, point) pair's evaluation from the Lagrange values:
    barycentric weights for every point at once, then 16 pairs a batch."""
    dev = values["h"].device
    points = []
    for _, pt in pairs:
        if pt not in points:
            points.append(pt)
    weights = frops.bary_weights(
        dom.omega_pows_device, field.from_ints(FR, points, dev),
        field.from_ints(FR, [dom.bary_scale(pt) for pt in points], dev),
        dom.omega_pows_mont)
    res = []
    for off in range(0, len(pairs), 16):
        chunk = pairs[off:off + 16]
        widx = torch.tensor([points.index(pt) for _, pt in chunk],
                            device=dev)
        res += field.to_ints(frops.eval_lagrange_many(
            torch.stack([values[nm] for nm, _ in chunk]), weights, widx))
    return res


def _selfcheck_quotient_identity(csys, dom, instances, evals, challenges,
                                 theta, beta, gamma, y, x) -> None:
    """H2T_SELFCHECK >= 1: the verifier's expected h(x) recomputed from the
    claimed evaluations with host ints, against the prover's own h(x).  A
    mismatch puts the fault in the witness, quotient or evaluations; a
    match with a failing verifier, in a commitment or the multiopen."""
    from .verifier import expected_h
    expected = expected_h(csys, dom, instances, challenges, theta, beta,
                          gamma, y, x, lambda nm, pt: evals[(nm, pt)])
    got = evals[("h", x)]
    if expected != got:
        line = (f"QUOTIENT IDENTITY MISMATCH at x: expected {expected:#x} "
                f"got {got:#x}")
    else:
        line = "quotient identity at x: OK"
    _verdict("selfcheck", "quotient identity", expected == got, "MISMATCH",
             line)


def _selfcheck_host_evals(dom, values: dict, evals: dict,
                          h_collapsed: torch.Tensor, x: int) -> None:
    """H2T_SELFCHECK=2: advice0, sigma0 and h at x by a barycentric sum on
    the host, and the collapsed h by Horner on the host, against the
    device's evaluations (the barycentric stage apart from the quotient)."""
    def host_bary(col, pt):
        acc, wi = 0, 1
        for v in field.to_ints(col):
            if v:
                acc = (acc + v * wi % rc.FR
                       * rc.finv((pt - wi) % rc.FR, rc.FR)) % rc.FR
            wi = wi * dom.omega % rc.FR
        return acc * dom.bary_scale(pt) % rc.FR

    for nm in ("advice0", "sigma0", "h"):
        got, want = evals[(nm, x)], host_bary(values[nm], x)
        _verdict("selfcheck2", f"bary({nm}, x)", got == want, "MISMATCH",
                 f"bary({nm}, x): " + ("OK" if got == want else
                                       f"MISMATCH got {got:#x} want "
                                       f"{want:#x}"))
    hh = 0
    for c in reversed(field.to_ints(h_collapsed)):
        hh = (hh * x + c) % rc.FR
    same = hh == evals[("h", x)]
    _verdict("selfcheck2", "horner(h_collapsed, x)", same, "MISMATCH",
             f"horner(h_collapsed, x) {'== ' if same else '!= '}"
             f"bary(h values); horner={hh:#x}")


def create_proof(params: ParamsKZG, pk: ProvingKey, witness, instances: list,
                 transcript, rng: BlindingRng | None = None) -> bytes:
    """witness: an (num_advice, n, 8) tensor (single phase) or a callable
    `witness(phase, challenges) -> {col: (n, 8) tensor}`; instances: per
    instance column, a list of Fr ints."""
    with trace.proving():
        return _create_proof(params, pk, witness, instances, transcript, rng)


def _create_proof(params, pk, witness, instances, transcript, rng):
    dev = pk.device
    LAST_STAGE_TIMES.clear()
    LAST_SELFCHECK.clear()
    selfcheck = os.environ.get("H2T_SELFCHECK")
    stages = trace.Ticks("prove", "H2T_PROFILE", sync=lambda: _sync(dev))

    def tick(stage):
        LAST_STAGE_TIMES[stage] = stages(stage)

    rng = rng or BlindingRng()
    vk = pk.vk
    csys = vk.cs
    dom = pk.domain()
    n = dom.n
    bf = csys.blinding_factors()
    u_row = n - bf - 1

    def blind(col, count_from):
        with trace.span("blinding"):
            col = col.clone()
            col[count_from:] = field.from_ints(FR, rng.fill(n - count_from),
                                               dev)
            return col

    # -- 0: vk and instances into the transcript ------------------------------
    transcript.common_scalar(vk.transcript_repr())
    for col in instances:
        for v in col:
            transcript.common_scalar(v)
    inst_lag = [instance_lagrange(col, n, dev) for col in instances]

    # -- 1: per phase: blind and commit advice, squeeze phase challenges ------
    if callable(witness):
        witness_fn = witness
    else:
        witness_fn = lambda phase, ch: (
            {i: witness[i] for i in range(csys.num_advice)} if phase == 0
            else {})
    advice_cols: list = [None] * csys.num_advice
    challenges: dict = {}
    for phase in range(csys.num_phases):
        with trace.span("witness", ("H2T_PROFILE2", f"phase{phase}",
                                    "witness_fn")):
            phase_cols = witness_fn(phase, dict(challenges))
        expected = [i for i in range(csys.num_advice)
                    if csys.advice_phases[i] == phase]
        assert sorted(phase_cols.keys()) == expected, \
            f"phase {phase}: witness must supply columns {expected}"
        batch = []
        for i in expected:
            advice_cols[i] = blind(phase_cols[i].to(dev), u_row)
            batch.append(advice_cols[i])
        bits = [csys.advice_value_bits.get(i) for i in expected]
        for pt in _commit_mixed(params, batch, bits, u_row):
            transcript.write_point(pt)
        for ci, cp in enumerate(csys.challenge_phases):
            if cp == phase:
                challenges[ci] = transcript.squeeze_challenge()
    del phase_cols, batch
    tick("phase commits")
    theta = transcript.squeeze_challenge()

    # -- 2: lookups: compress, permute, commit --------------------------------
    def leaf(e):
        return _eval_expr_lagrange(e, n, advice_cols, pk.fixed_lagrange,
                                   inst_lag, challenges, dev)

    lookups, lk_batch, lk_bits = [], [], []
    for lk in csys.lookups:
        a_comp = _compress([p[0] for p in lk.pairs], theta, leaf)
        s_comp = _compress([p[1] for p in lk.pairs], theta, leaf)
        a_arr, s_arr, ok = frops.lookup_permute_device(a_comp, s_comp, u_row,
                                                       lk.max_bits)
        if not ok:
            raise ValueError(f"lookup '{lk.name}' failure: input not in table")
        a_arr, s_arr = blind(a_arr, u_row), blind(s_arr, u_row)
        lk_batch += [a_arr, s_arr]
        lk_bits += [lk.max_bits, lk.max_bits]
        lookups.append(dict(a=a_comp, s=s_comp, a_perm=a_arr, s_perm=s_arr))
    for pt in _commit_mixed(params, lk_batch, lk_bits, u_row):
        transcript.write_point(pt)
    tick("lookup permute+commit")
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    # -- 3/4: grand products, then the vanishing random poly ------------------
    def col_lagrange(col):
        return {FIXED: pk.fixed_lagrange, ADVICE: advice_cols,
                INSTANCE: inst_lag}[col.kind][col.index]

    big = big_domain(n)
    perm_vals = [col_lagrange(c) for c in csys.permutation_columns]
    num_chunks = csys.num_permutation_chunks()
    with trace.span("blinding"):
        blinds = [field.from_ints(FR, rng.fill(bf), dev)
                  for _ in range(num_chunks + len(lookups))]
    zs, num, den = _grand_products(pk, perm_vals, lookups, beta, gamma,
                                   blinds, streamed=big,
                                   keep=selfcheck == "3")
    del perm_vals, lk_batch
    perm_zs = zs[:num_chunks]
    for li, lkd in enumerate(lookups):
        lkd["z"] = zs[num_chunks + li]
    if selfcheck == "3":
        _selfcheck_grand_products(perm_zs, zs[num_chunks:], num, den, u_row)
    del num, den
    if big:
        for lkd in lookups:               # read by the grand products only
            lkd["a"] = lkd["s"] = None
    random_vals = rng.fill_words(n, dev)
    for pt in commit_many_lagrange(params, zs + [random_vals]):
        transcript.write_point(pt)
    del zs
    tick("grand products+random")
    y = transcript.squeeze_challenge()

    # -- 5: quotient ----------------------------------------------------------
    chal_list = [theta, beta, gamma, y] + [challenges[i]
                                           for i in range(csys.num_challenges)]
    chal = field.from_ints(FR, chal_list, dev)
    fresh = (advice_cols + inst_lag + perm_zs
             + [d["z"] for d in lookups] + [d["a_perm"] for d in lookups]
             + [d["s_perm"] for d in lookups])
    quot = quotient_pipeline(pk)

    def move_witness(to):
        """The witness columns to `to`: the host while the cosets run."""
        advice_cols[:] = [c.to(to) for c in advice_cols]
        perm_zs[:] = [c.to(to) for c in perm_zs]
        for d in lookups:
            for key in ("z", "a_perm", "s_perm"):
                d[key] = d[key].to(to)

    if big:                   # idle through the quotient
        params.park_fixed_base(lagrange=True)
        pk.park_lagrange()
    stash = big and isinstance(quot, _QuotientCoset) and not selfcheck
    try:
        h_pieces = quot(pk, fresh, chal,
                        (lambda: move_witness("cpu")) if stash else None)
        del fresh
        for pt in commit_many(params, h_pieces):
            transcript.write_point(pt)
    finally:
        if big:
            params.park_fixed_base(lagrange=False)
            pk.restore_lagrange()
    if stash:                 # `quot` moved them once it had staged them
        move_witness(dev)
    tick("quotient+commit")
    x = transcript.squeeze_challenge()
    xn = pow(x, n, rc.FR)

    # collapsed h for the multiopen: sum_i x^{n i} h_i
    h_collapsed = None
    xni = 1
    for piece in h_pieces:
        term = field.mul_const(FR, piece, xni)
        h_collapsed = term if h_collapsed is None else field.add(
            FR, h_collapsed, term)
        xni = xni * xn % rc.FR

    # -- 6: evaluations, barycentric from the Lagrange values ----------------
    values = {}
    for i in range(csys.num_advice):
        values[f"advice{i}"] = advice_cols[i]
    for i in range(csys.num_fixed):
        values[f"fixed{i}"] = pk.fixed_lagrange[i]
    for c in range(num_chunks):
        values[f"perm_z{c}"] = perm_zs[c]
    for gpos in range(pk.sigma_lagrange.shape[0]):
        values[f"sigma{gpos}"] = pk.sigma_lagrange[gpos]
    for li in range(len(lookups)):
        values[f"lookup{li}_z"] = lookups[li]["z"]
        values[f"lookup{li}_a"] = lookups[li]["a_perm"]
        values[f"lookup{li}_s"] = lookups[li]["s_perm"]
    values["random"] = random_vals
    values["h"] = dom.coeff_to_lagrange(h_collapsed)

    x_next = dom.rotate_omega(x, 1)
    x_prev = dom.rotate_omega(x, -1)
    x_last = dom.rotate_omega(x, u_row)
    pairs: list = []

    def need(name, point):
        if (name, point) not in pairs:
            pairs.append((name, point))

    for (i, r) in csys.advice_queries:
        need(f"advice{i}", dom.rotate_omega(x, r))
    for (i, r) in csys.fixed_queries:
        need(f"fixed{i}", dom.rotate_omega(x, r))
    need("random", x)
    for gpos in range(pk.sigma_lagrange.shape[0]):
        need(f"sigma{gpos}", x)
    for c in range(num_chunks):
        need(f"perm_z{c}", x)
        need(f"perm_z{c}", x_next)
        if c != num_chunks - 1:
            need(f"perm_z{c}", x_last)
    for li in range(len(lookups)):
        need(f"lookup{li}_z", x)
        need(f"lookup{li}_z", x_next)
        need(f"lookup{li}_a", x)
        need(f"lookup{li}_a", x_prev)
        need(f"lookup{li}_s", x)
    need("h", x)

    if os.environ.get("H2T_EVAL_MODE") == "coeff":
        names = list(dict.fromkeys(nm for nm, _ in pairs))
        coeff = dom.lagrange_to_coeff(torch.stack([values[nm]
                                                   for nm in names]))
        res = field.to_ints(frops.poly_eval_many(
            coeff[[names.index(nm) for nm, _ in pairs]],
            field.from_ints(FR, [pt for _, pt in pairs], dev)))
        del coeff
    else:
        res = _eval_barycentric(dom, values, pairs)
    evals = dict(zip(pairs, res))

    def ev(name, point):
        return evals[(name, point)]

    for (i, r) in csys.advice_queries:
        transcript.write_scalar(ev(f"advice{i}", dom.rotate_omega(x, r)))
    for (i, r) in csys.fixed_queries:
        transcript.write_scalar(ev(f"fixed{i}", dom.rotate_omega(x, r)))
    transcript.write_scalar(ev("random", x))
    for gpos in range(pk.sigma_lagrange.shape[0]):
        transcript.write_scalar(ev(f"sigma{gpos}", x))
    for c in range(num_chunks):
        transcript.write_scalar(ev(f"perm_z{c}", x))
        transcript.write_scalar(ev(f"perm_z{c}", x_next))
    for c in range(num_chunks - 1):
        transcript.write_scalar(ev(f"perm_z{c}", x_last))
    for li in range(len(lookups)):
        transcript.write_scalar(ev(f"lookup{li}_z", x))
        transcript.write_scalar(ev(f"lookup{li}_z", x_next))
        transcript.write_scalar(ev(f"lookup{li}_a", x))
        transcript.write_scalar(ev(f"lookup{li}_a", x_prev))
        transcript.write_scalar(ev(f"lookup{li}_s", x))
    tick("evals")
    if selfcheck:
        _selfcheck_quotient_identity(csys, dom, instances, evals, challenges,
                                     theta, beta, gamma, y, x)
    if selfcheck == "2":
        _selfcheck_host_evals(dom, values, evals, h_collapsed, x)

    # -- 7: multiopen ---------------------------------------------------------
    queries = []

    def q(name, point):
        queries.append(ProverQuery(poly=values[name], point=point,
                                   eval=ev(name, point), name=name))

    for (i, r) in csys.advice_queries:
        q(f"advice{i}", dom.rotate_omega(x, r))
    for c in range(num_chunks):
        q(f"perm_z{c}", x)
        q(f"perm_z{c}", x_next)
        if c != num_chunks - 1:
            q(f"perm_z{c}", x_last)
    for li in range(len(lookups)):
        q(f"lookup{li}_z", x)
        q(f"lookup{li}_z", x_next)
        q(f"lookup{li}_a", x)
        q(f"lookup{li}_a", x_prev)
        q(f"lookup{li}_s", x)
    for (i, r) in csys.fixed_queries:
        q(f"fixed{i}", dom.rotate_omega(x, r))
    for gpos in range(pk.sigma_lagrange.shape[0]):
        q(f"sigma{gpos}", x)
    q("random", x)
    q("h", x)
    open_shplonk(params, queries, transcript, dom)
    tick("multiopen")
    return transcript.finalize()
