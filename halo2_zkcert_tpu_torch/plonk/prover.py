"""PLONKish prover: create_proof.

Counterpart of halo2_zkcert_tpu/plonk/prover.py on its one-shot,
small-residency path: phase advice commits -> lookup permute and commit ->
permutation and lookup grand products (all Z columns in one batched pass)
-> vanishing random poly -> quotient on the extended coset (the forest as
one K4 launch) -> barycentric evaluations at x -> SHPLONK multiopen.  Every
O(n) step is a device op on the proving key's device; the Fiat-Shamir
transcript and per-poly scalar glue stay on the host.  Given the same pk,
witness, instances and blinding seed the proof bytes equal the reference's.

The reference's debugging knobs, read from the environment at each call
and off by default; they print the reference's lines and change no byte:
  H2T_SELFCHECK  1: the verifier's h(x) recomputed from the claimed
                 evaluations on the host (`_selfcheck_quotient_identity`);
                 2: and advice0, sigma0 and h evaluated at x on the host
                 (barycentric), the collapsed h by Horner; 3: and the grand
                 products' recurrences over H (K1 residuals on the device);
                 4, 5: and h over 8 extended rows recomputed with Python
                 ints from K4's own leaves (`_oracle_quotient_window`).
                 The verdicts also land in LAST_SELFCHECK.
  H2T_EVAL_MODE  coeff: the evaluations from coefficient forms (inverse
                 transform, then `frops.poly_eval_many`).
  H2T_PROFILE    the stage ticks `[prove] <stage>: <s>` (and keygen's).
  H2T_PROFILE2   the witness passes, the quotient's sub-stages and the
                 commitments (plonk/kzg.py).
"""
from __future__ import annotations

import os
import time

import torch

from ..ops import field, frops, ntt
from ..ops.field import FR
from ..utils import refcrypto as rc
from . import expression as ex
from .assignment import BlindingRng
from .cs import ADVICE, DELTA, FIXED, INSTANCE
from .keygen import ProvingKey
from .kzg import ParamsKZG, commit_many, commit_many_lagrange
from .quotient import AUX, compile_tape, leaf_layout, quotient_forest
from .shplonk import ProverQuery, open_shplonk

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


def _grand_products(pk: ProvingKey, perm_vals, lookups, beta: int,
                    gamma: int, blinds) -> tuple:
    """Every permutation-chunk Z (chained across chunks) and every lookup
    Z, blinding rows set; one batched inversion and one batched prefix
    product for all of them.  Returns (the Zs, their numerators and
    denominators stacked, (Z count, n, 8) each, or None without Zs)."""
    csys = pk.vk.cs
    dom = pk.domain()
    n, dev = dom.n, pk.device
    bf = csys.blinding_factors()
    u_row = n - bf - 1
    chunk_len = csys.permutation_chunk_len()
    nperm = len(csys.permutation_columns)
    beta_t, gamma_t = field.const(FR, beta, dev), field.const(FR, gamma, dev)
    ob = field.mul_const(FR, dom.omega_pows_device, beta)
    nums, dens = [], []
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
        nums.append(num)
        dens.append(den)
    for lk in lookups:
        nums.append(field.mul(FR, field.add(FR, lk["a"], beta_t),
                              field.add(FR, lk["s"], gamma_t)))
        dens.append(field.mul(FR, field.add(FR, lk["a_perm"], beta_t),
                              field.add(FR, lk["s_perm"], gamma_t)))
    if not nums:
        return [], None, None
    num, den = torch.stack(nums), torch.stack(dens)
    ratio = field.mul(FR, num, frops.batch_inv(den.reshape(-1, 8))
                      .reshape(den.shape))
    one = field.one(dev, (len(nums), 1))
    zs = frops.prefix_product_batched(torch.cat((one, ratio[:, :-1]), dim=1))
    outs = []
    start = None
    for i in range(len(nums)):
        z = zs[i]
        if i < csys.num_permutation_chunks() and start is not None:
            z = field.mul(FR, z, start)
        if i < csys.num_permutation_chunks():
            start = z[u_row].clone()
        z = z.clone()
        z[n - bf:] = blinds[i]
        outs.append(z)
    return outs, num, den


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


class _Quotient:
    """Per-pk quotient pipeline: the pk's extended columns (kept in
    Montgomery form, what K4 reads) and the tape are built once; each proof
    transforms its fresh columns onto the coset in that form, runs K4 and
    hands its result to the inverse transform as it is."""

    def __init__(self, pk: ProvingKey):
        csys = pk.vk.cs
        dom = pk.domain()
        n, ext_n, dev = dom.n, dom.extended_n, pk.device
        self.dom, self.csys = dom, csys
        self.tape = compile_tape(csys, n, ext_n)
        self.layout = leaf_layout(csys)
        self.u_row = u_row = n - csys.blinding_factors() - 1
        basis = torch.zeros((3, n, 8), dtype=torch.int32, device=dev)
        basis[0, 0, 0] = 1
        basis[1, u_row, 0] = 1
        basis[2, u_row + 1:, 0] = 1
        aux = dom.coeff_to_extended(dom.lagrange_to_coeff(basis), True)
        ident = field.mul_const(FR, ntt.power_table(dom.extended_omega, ext_n,
                                                    dev), dom.G_COSET)
        parts = [dom.coeff_to_extended(pk.fixed_coeff, True),
                 dom.coeff_to_extended(pk.sigma_coeff, True), aux,
                 field.to_mont(FR, torch.stack((ident, dom.zh_inv_extended)))]
        self.static = torch.cat(parts)
        assert self.static.shape[0] == self.layout[("aux", AUX[-1])] + 1

    def __call__(self, lag_cols: torch.Tensor, chal: torch.Tensor):
        """lag_cols: (C, n, 8) advice, instance, permutation Zs, lookup Z,
        permuted inputs, permuted tables (leaf_layout order).  Returns the
        quotient pieces (qd, n, 8) in coefficient form."""
        dom = self.dom
        t_last = [time.perf_counter()]

        def tick2(stage):
            if os.environ.get("H2T_PROFILE2"):
                _sync(lag_cols.device)
                t = time.perf_counter()
                print(f"    [quot] {stage}: {t - t_last[0]:.3f}s", flush=True)
                t_last[0] = t

        coeff = dom.lagrange_to_coeff(lag_cols)
        tick2(f"lag2coeff x{lag_cols.shape[0]}")
        ext = dom.coeff_to_extended(coeff, True)
        del coeff                              # not held through K4
        tick2(f"coeff2ext x{lag_cols.shape[0]}")
        leaves = torch.cat((self.static, ext))
        h = quotient_forest(leaves, self.tape.const_table(chal), self.tape)
        tick2("pointwise")
        if os.environ.get("H2T_SELFCHECK") in ("4", "5"):
            _oracle_quotient_window(self, leaves, field.to_ints(chal), h)
        coeffs = dom.extended_to_coeff(h, True)
        tick2("h coset_intt")
        return coeffs.reshape(-1, dom.n, 8)[:dom.quotient_degree]


def _oracle_quotient_window(quot: _Quotient, leaves: torch.Tensor,
                            chal: list, h: torch.Tensor, s: int = 17,
                            W: int = 8) -> None:
    """H2T_SELFCHECK=4, 5: h over the extended rows [s, s + W) recomputed
    with Python ints from K4's own leaves (Montgomery form), read at each
    rotation's stride, against K4's output there: an exact oracle for the
    tape and the kernel."""
    csys, dom, lay = quot.csys, quot.dom, quot.layout
    n, ext_n = dom.n, dom.extended_n
    stride = ext_n // n
    u_row = quot.u_row
    chunk_len = csys.permutation_chunk_len()
    perm_cols = csys.permutation_columns
    chunks = [perm_cols[i:i + chunk_len]
              for i in range(0, len(perm_cols), chunk_len)]
    r_inv = rc.finv(FR.r, rc.FR)
    theta_i, beta_i, gamma_i, y_i = chal[:4]

    def rows_of(col, r=0):
        idx = torch.arange(s + r * stride, s + W + r * stride) % ext_n
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


def quotient_pipeline(pk: ProvingKey) -> _Quotient:
    q = pk.__dict__.get("_quotient")
    if q is None:
        q = _Quotient(pk)
        pk.__dict__["_quotient"] = q
    return q


def _eval_barycentric(dom, values: dict, pairs: list) -> list:
    """Each (name, point) pair's evaluation from the Lagrange values:
    barycentric weights for every point at once, 16 pairs a batch."""
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
    dev = pk.device
    LAST_STAGE_TIMES.clear()
    LAST_SELFCHECK.clear()
    selfcheck = os.environ.get("H2T_SELFCHECK")
    profile = bool(os.environ.get("H2T_PROFILE"))
    profile2 = bool(os.environ.get("H2T_PROFILE2"))
    t_last = [time.perf_counter()]

    def tick(stage):
        _sync(dev)
        t = time.perf_counter()
        LAST_STAGE_TIMES[stage] = t - t_last[0]
        if profile:
            print(f"  [prove] {stage}: {t - t_last[0]:.3f}s", flush=True)
        t_last[0] = t

    rng = rng or BlindingRng()
    vk = pk.vk
    csys = vk.cs
    dom = pk.domain()
    n = dom.n
    bf = csys.blinding_factors()
    u_row = n - bf - 1

    def blind(col, count_from):
        col = col.clone()
        col[count_from:] = field.from_ints(FR, rng.fill(n - count_from), dev)
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
        t_w = time.perf_counter()
        phase_cols = witness_fn(phase, dict(challenges))
        if profile2:
            print(f"    [phase{phase}] witness_fn: "
                  f"{time.perf_counter() - t_w:.3f}s", flush=True)
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

    perm_vals = [col_lagrange(c) for c in csys.permutation_columns]
    num_chunks = csys.num_permutation_chunks()
    blinds = [field.from_ints(FR, rng.fill(bf), dev)
              for _ in range(num_chunks + len(lookups))]
    zs, num, den = _grand_products(pk, perm_vals, lookups, beta, gamma,
                                   blinds)
    perm_zs = zs[:num_chunks]
    for li, lkd in enumerate(lookups):
        lkd["z"] = zs[num_chunks + li]
    if selfcheck == "3":
        _selfcheck_grand_products(perm_zs, zs[num_chunks:], num, den, u_row)
    del num, den
    random_vals = rng.fill_words(n, dev)
    for pt in commit_many_lagrange(params, zs + [random_vals]):
        transcript.write_point(pt)
    tick("grand products+random")
    y = transcript.squeeze_challenge()

    # -- 5: quotient ----------------------------------------------------------
    chal_list = [theta, beta, gamma, y] + [challenges[i]
                                           for i in range(csys.num_challenges)]
    chal = field.from_ints(FR, chal_list, dev)
    fresh = (advice_cols + inst_lag + perm_zs
             + [d["z"] for d in lookups] + [d["a_perm"] for d in lookups]
             + [d["s_perm"] for d in lookups])
    h_pieces = quotient_pipeline(pk)(torch.stack(fresh), chal)
    for pt in commit_many(params, h_pieces):
        transcript.write_point(pt)
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
