"""PLONKish prover: create_proof.

Counterpart of halo2_zkcert_tpu/plonk/prover.py on its one-shot,
small-residency path: phase advice commits -> lookup permute and commit ->
permutation and lookup grand products (all Z columns in one batched pass)
-> vanishing random poly -> quotient on the extended coset (the forest as
one K4 launch) -> barycentric evaluations at x -> SHPLONK multiopen.  Every
O(n) step is a device op on the proving key's device; the Fiat-Shamir
transcript and per-poly scalar glue stay on the host.  Given the same pk,
witness, instances and blinding seed the proof bytes equal the reference's.
"""
from __future__ import annotations

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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def instance_lagrange(vals: list, n: int, device) -> torch.Tensor:
    return field.from_ints(FR, list(vals) + [0] * (n - len(vals)), device)


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
                    gamma: int, blinds) -> list:
    """Every permutation-chunk Z (chained across chunks) and every lookup
    Z, blinding rows set; one batched inversion and one batched prefix
    product for all of them."""
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
        return []
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
    return outs


class _Quotient:
    """Per-pk quotient pipeline: the pk's extended columns (kept in
    Montgomery form, what K4 reads) and the tape are built once; each proof
    transforms its fresh columns onto the coset in that form, runs K4 and
    hands its result to the inverse transform as it is."""

    def __init__(self, pk: ProvingKey):
        csys = pk.vk.cs
        dom = pk.domain()
        n, ext_n, dev = dom.n, dom.extended_n, pk.device
        self.dom = dom
        self.tape = compile_tape(csys, n, ext_n)
        self.layout = leaf_layout(csys)
        u_row = n - csys.blinding_factors() - 1
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
        ext = dom.coeff_to_extended(dom.lagrange_to_coeff(lag_cols), True)
        leaves = torch.cat((self.static, ext))
        h = quotient_forest(leaves, self.tape.const_table(chal), self.tape)
        coeffs = dom.extended_to_coeff(h, True)
        return coeffs.reshape(-1, dom.n, 8)[:dom.quotient_degree]


def quotient_pipeline(pk: ProvingKey) -> _Quotient:
    q = pk.__dict__.get("_quotient")
    if q is None:
        q = _Quotient(pk)
        pk.__dict__["_quotient"] = q
    return q


def create_proof(params: ParamsKZG, pk: ProvingKey, witness, instances: list,
                 transcript, rng: BlindingRng | None = None) -> bytes:
    """witness: an (num_advice, n, 8) tensor (single phase) or a callable
    `witness(phase, challenges) -> {col: (n, 8) tensor}`; instances: per
    instance column, a list of Fr ints."""
    dev = pk.device
    LAST_STAGE_TIMES.clear()
    t_last = [time.perf_counter()]

    def tick(stage):
        _sync(dev)
        t = time.perf_counter()
        LAST_STAGE_TIMES[stage] = t - t_last[0]
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
    zs = _grand_products(pk, perm_vals, lookups, beta, gamma, blinds)
    perm_zs = zs[:num_chunks]
    for li, lkd in enumerate(lookups):
        lkd["z"] = zs[num_chunks + li]
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
