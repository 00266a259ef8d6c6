"""Loader-generic PLONK verifier: verification as a straight-line program.

Counterpart of halo2_zkcert_tpu/plonk/verifier_core.py.  Reference
behavior: snark-verifier's `Loader` abstraction (Cargo.lock:2676 [dep]):
one verification algorithm, several interpreters --

* `NativeLoader` (here) -- host ints and the real pairing; it gives the
  verdict of `plonk.verifier.verify_proof` on every proof;
* the circuit loader (`circuits/agg_loader.py`) -- GateBuilder cells, the
  in-circuit replay of the aggregation circuit.

For a fixed vk the verifier has NO data-dependent control flow (rotation
sets, query counts, gate structure all derive from the CS), so the same
`verify_core` drives every loader.

The loader contract (duck-typed):
  scalars:  s_const(v) s_add(a,b) s_sub(a,b) s_mul(a,b) s_inv(a)
  transcript: t_common_scalar(s), t_read_scalar() t_read_point()
              t_squeeze() -- points are opaque handles
  instances: instance_scalar(col, row) -> scalar handle
  points:   p_identity() p_acc(acc, point_handle, scalar) -> acc
            p_acc_generator(acc, scalar)  (scalar * G1)
            final_check(w_point, acc, z0_inv, u) -> loader-specific result
  optional: vk_repr_scalar(vk) -> the vk's transcript repr as a scalar
"""
from __future__ import annotations

from ..utils import refcrypto as rc
from . import expression as ex
from .cs import ADVICE, DELTA, FIXED
from .keygen import VerifyingKey


def verify_core(loader, vk: VerifyingKey, num_instance_rows: list):
    """Run the verification program through `loader`.

    num_instance_rows: instance column lengths (static). Returns whatever
    loader.final_check returns.
    """
    L = loader
    csys = vk.cs
    dom = vk.domain()
    n = vk.n
    bf = csys.blinding_factors()
    u_row = n - bf - 1
    chunk_len = csys.permutation_chunk_len()
    num_chunks = csys.num_permutation_chunks()
    num_pieces = csys.quotient_degree
    num_sigmas = len(csys.permutation_columns)

    one = L.s_const(1)

    def s_pow(base, e: int):
        acc = None
        b = base
        while e:
            if e & 1:
                acc = b if acc is None else L.s_mul(acc, b)
            b = L.s_mul(b, b)
            e >>= 1
        return acc if acc is not None else one

    # vk transcript repr: loaders supporting vk-from-witness universality
    # (agg_loader.CircuitLoader) expose it through a hook so the repr can
    # be a witness cell (reference VerifierUniversality::Full, lib.rs:47)
    if hasattr(L, "vk_repr_scalar"):
        L.t_common_scalar(L.vk_repr_scalar(vk))
    else:
        L.t_common_scalar(L.s_const(vk.transcript_repr()))
    for col, rows in enumerate(num_instance_rows):
        for r in range(rows):
            L.t_common_scalar(L.instance_scalar(col, r))

    advice_commits = [None] * csys.num_advice
    challenges = {}
    for phase in range(csys.num_phases):
        for i in range(csys.num_advice):
            if csys.advice_phases[i] == phase:
                advice_commits[i] = L.t_read_point()
        for ci, cp in enumerate(csys.challenge_phases):
            if cp == phase:
                challenges[ci] = L.t_squeeze()
    theta = L.t_squeeze()
    lookup_permuted = [(L.t_read_point(), L.t_read_point()) for _ in csys.lookups]
    beta = L.t_squeeze()
    gamma = L.t_squeeze()
    perm_z_commits = [L.t_read_point() for _ in range(num_chunks)]
    lookup_z_commits = [L.t_read_point() for _ in csys.lookups]
    random_commit = L.t_read_point()
    y = L.t_squeeze()
    h_commits = [L.t_read_point() for _ in range(num_pieces)]
    x = L.t_squeeze()
    xn = s_pow(x, n)

    advice_evals = [L.t_read_scalar() for _ in csys.advice_queries]
    fixed_evals = [L.t_read_scalar() for _ in csys.fixed_queries]
    random_eval = L.t_read_scalar()
    sigma_evals = [L.t_read_scalar() for _ in range(num_sigmas)]
    perm_z = []
    for _ in range(num_chunks):
        perm_z.append({"x": L.t_read_scalar(), "next": L.t_read_scalar()})
    for c in range(num_chunks - 1):
        perm_z[c]["last"] = L.t_read_scalar()
    lookup_evals = []
    for _ in csys.lookups:
        lookup_evals.append({
            "z": L.t_read_scalar(), "z_next": L.t_read_scalar(),
            "a": L.t_read_scalar(), "a_prev": L.t_read_scalar(),
            "s": L.t_read_scalar()})

    # ---- instance evaluation (barycentric over the provided rows) ----------
    zh = L.s_sub(xn, one)
    n_inv = L.s_const(rc.finv(n, rc.FR))

    omega = dom.omega

    def instance_eval(col: int, rot: int):
        # p(z) = Z_H(z)/n * sum_i v_i w^i / (z - w^i), z = omega^rot x
        z = L.s_mul(x, L.s_const(pow(omega if rot >= 0 else dom.omega_inv,
                                     abs(rot), rc.FR)))
        acc = None
        for i in range(num_instance_rows[col]):
            wi = L.s_const(pow(omega, i, rc.FR))
            term = L.s_mul(L.s_mul(L.instance_scalar(col, i), wi),
                           L.s_inv(L.s_sub(z, wi)))
            acc = term if acc is None else L.s_add(acc, term)
        if acc is None:
            return L.s_const(0)
        zh_z = L.s_sub(s_pow(z, n), one)
        return L.s_mul(L.s_mul(zh_z, n_inv), acc)

    inst_cache: dict = {}

    def instance_eval_cached(col, rot):
        if (col, rot) not in inst_cache:
            inst_cache[(col, rot)] = instance_eval(col, rot)
        return inst_cache[(col, rot)]

    adv_map = {q: advice_evals[j] for j, q in enumerate(csys.advice_queries)}
    fix_map = {q: fixed_evals[j] for j, q in enumerate(csys.fixed_queries)}

    def eval_expr(e: ex.Expr):
        return ex.evaluate(
            e,
            constant=lambda v: L.s_const(v % rc.FR),
            fixed=lambda i, r: fix_map[(i, r)],
            advice=lambda i, r: adv_map[(i, r)],
            instance=instance_eval_cached,
            challenge=lambda i: challenges[i],
            add=L.s_add, mul=L.s_mul,
            scale=lambda a, s: L.s_mul(a, L.s_const(s % rc.FR)),
        )

    # l_0, l_last, l_blind at x  (L_i(x) = w^i/n * zh / (x - w^i))
    def l_i(i: int):
        wi = L.s_const(pow(omega, i, rc.FR))
        return L.s_mul(L.s_mul(zh, L.s_mul(wi, n_inv)),
                       L.s_inv(L.s_sub(x, wi)))

    l0 = l_i(0)
    l_last = l_i(u_row)
    l_blind = None
    for i in range(u_row + 1, n):
        t = l_i(i)
        l_blind = t if l_blind is None else L.s_add(l_blind, t)
    active = L.s_sub(L.s_sub(one, l_last), l_blind)

    exprs = []
    for _, g in csys.gates:
        exprs.append(eval_expr(g))

    if num_chunks:
        exprs.append(L.s_mul(l0, L.s_sub(one, perm_z[0]["x"])))
        zl = perm_z[-1]["x"]
        exprs.append(L.s_mul(l_last, L.s_sub(L.s_mul(zl, zl), zl)))
        for c in range(1, num_chunks):
            exprs.append(L.s_mul(l0, L.s_sub(perm_z[c]["x"],
                                             perm_z[c - 1]["last"])))

        def col_eval(col):
            if col.kind == ADVICE:
                return adv_map[(col.index, 0)]
            if col.kind == FIXED:
                return fix_map[(col.index, 0)]
            return instance_eval_cached(col.index, 0)

        for ci in range(num_chunks):
            chunk = csys.permutation_columns[ci * chunk_len:(ci + 1) * chunk_len]
            left = perm_z[ci]["next"]
            right = perm_z[ci]["x"]
            for pos, col in enumerate(chunk):
                gpos = ci * chunk_len + pos
                v = col_eval(col)
                left = L.s_mul(left, L.s_add(L.s_add(
                    v, L.s_mul(beta, sigma_evals[gpos])), gamma))
                right = L.s_mul(right, L.s_add(L.s_add(
                    v, L.s_mul(L.s_const(pow(DELTA, gpos, rc.FR)),
                               L.s_mul(beta, x))), gamma))
            exprs.append(L.s_mul(active, L.s_sub(left, right)))

    for lk, le in zip(csys.lookups, lookup_evals):
        a_comp = None
        for p_in, _ in lk.pairs:
            v = eval_expr(p_in)
            a_comp = v if a_comp is None else L.s_add(L.s_mul(a_comp, theta), v)
        s_comp = None
        for _, p_tab in lk.pairs:
            v = eval_expr(p_tab)
            s_comp = v if s_comp is None else L.s_add(L.s_mul(s_comp, theta), v)
        exprs.append(L.s_mul(l0, L.s_sub(one, le["z"])))
        exprs.append(L.s_mul(l_last, L.s_sub(L.s_mul(le["z"], le["z"]),
                                             le["z"])))
        lhs = L.s_mul(L.s_mul(le["z_next"], L.s_add(le["a"], beta)),
                      L.s_add(le["s"], gamma))
        rhs = L.s_mul(L.s_mul(le["z"], L.s_add(a_comp, beta)),
                      L.s_add(s_comp, gamma))
        exprs.append(L.s_mul(active, L.s_sub(lhs, rhs)))
        exprs.append(L.s_mul(l0, L.s_sub(le["a"], le["s"])))
        exprs.append(L.s_mul(L.s_mul(active, L.s_sub(le["a"], le["s"])),
                             L.s_sub(le["a"], le["a_prev"])))

    h_eval = None
    for e in exprs:
        h_eval = e if h_eval is None else L.s_add(L.s_mul(h_eval, y), e)
    expected_h = L.s_mul(h_eval, L.s_inv(zh))

    # ---- multiopen queries (canonical order == prover.py) -------------------
    # a point is its rotation: scalar value omega^rot * x
    rot_cache = {}

    def point_scalar(rot: int):
        if rot not in rot_cache:
            w = pow(omega, rot % n, rc.FR)
            rot_cache[rot] = L.s_mul(x, L.s_const(w))
        return rot_cache[rot]

    queries = []   # (commitment handle | ("fixed",i) ..., rot, eval, name)

    def q(comm, rot, evl, name):
        queries.append((comm, rot, evl, name))

    for j, (i, r) in enumerate(csys.advice_queries):
        q(advice_commits[i], r, advice_evals[j], f"advice{i}")
    for c in range(num_chunks):
        q(perm_z_commits[c], 0, perm_z[c]["x"], f"perm_z{c}")
        q(perm_z_commits[c], 1, perm_z[c]["next"], f"perm_z{c}")
        if c != num_chunks - 1:
            q(perm_z_commits[c], u_row, perm_z[c]["last"], f"perm_z{c}")
    for li, le in enumerate(lookup_evals):
        a_c, s_c = lookup_permuted[li]
        q(lookup_z_commits[li], 0, le["z"], f"lookup{li}_z")
        q(lookup_z_commits[li], 1, le["z_next"], f"lookup{li}_z")
        q(a_c, 0, le["a"], f"lookup{li}_a")
        q(a_c, -1, le["a_prev"], f"lookup{li}_a")
        q(s_c, 0, le["s"], f"lookup{li}_s")
    for j, (i, r) in enumerate(csys.fixed_queries):
        q(("vk_fixed", i), r, fixed_evals[j], f"fixed{i}")
    for gpos in range(num_sigmas):
        q(("vk_sigma", gpos), 0, sigma_evals[gpos], f"sigma{gpos}")
    q(random_commit, 0, random_eval, "random")
    q(("h_collapsed", h_commits, xn), 0, expected_h, "h")

    # ---- SHPLONK verify (mirrors shplonk.verify_shplonk) ---------------------
    by_poly: dict = {}
    poly_order = []
    for comm, rot, evl, name in queries:
        if name not in by_poly:
            by_poly[name] = {}
            poly_order.append(name)
        by_poly[name][rot] = (comm, evl)
    sets: dict = {}
    set_order = []
    for name in poly_order:
        rots = tuple(sorted(by_poly[name].keys()))
        if rots not in sets:
            sets[rots] = []
            set_order.append(rots)
        sets[rots].append(name)
    super_rots = []
    for rots in set_order:
        for r in rots:
            if r not in super_rots:
                super_rots.append(r)

    yv = L.t_squeeze()   # within-set combiner

    combined = []        # (rots, [(name, comm)], [evals per point combined])
    for rots in set_order:
        names = sets[rots]
        evs = [None] * len(rots)
        comms = []
        yk = one
        first = True
        for name in names:
            comm0 = by_poly[name][rots[0]][0]
            comms.append((name, comm0, yk))
            for t, rr in enumerate(rots):
                term = by_poly[name][rr][1] if first else \
                    L.s_mul(yk, by_poly[name][rr][1])
                evs[t] = term if evs[t] is None else L.s_add(evs[t], term)
            yk = L.s_mul(yk, yv)
            first = False
        combined.append((rots, comms, evs))

    v = L.t_squeeze()
    h_open = L.t_read_point()
    u = L.t_squeeze()

    # vanishing evals over rotation points: Z(u) for point sets
    def z_eval(rots_subset):
        acc = None
        for rr in rots_subset:
            t = L.s_sub(u, point_scalar(rr))
            acc = t if acc is None else L.s_mul(acc, t)
        return acc if acc is not None else one

    zt_eval = z_eval(super_rots)

    # Lagrange interpolation r_i(u) from combined evals
    def r_u(rots, evs):
        acc = None
        for i, ri in enumerate(rots):
            xi = point_scalar(ri)
            num = None
            den = None
            for j, rj in enumerate(rots):
                if i == j:
                    continue
                xj = point_scalar(rj)
                tn = L.s_sub(u, xj)
                td = L.s_sub(xi, xj)
                num = tn if num is None else L.s_mul(num, tn)
                den = td if den is None else L.s_mul(den, td)
            term = evs[i]
            if num is not None:
                term = L.s_mul(term, L.s_mul(num, L.s_inv(den)))
            acc = term if acc is None else L.s_add(acc, term)
        return acc

    # [L] accumulation
    acc = L.p_identity()
    const_acc = None
    vk_pow = one
    z_diff_0 = None
    first_set = True
    for rots, comms, evs in combined:
        diff = [rr for rr in super_rots if rr not in rots]
        z_i = z_eval(diff)
        if z_diff_0 is None:
            z_diff_0 = z_i
        w = z_i if first_set else L.s_mul(vk_pow, z_i)
        for name, comm, yk in comms:
            acc = L.p_acc(acc, comm, L.s_mul(w, yk))
        t = L.s_mul(w, r_u(rots, evs))
        const_acc = t if const_acc is None else L.s_add(const_acc, t)
        vk_pow = L.s_mul(vk_pow, v)
        first_set = False
    minus1 = L.s_const(rc.FR - 1)
    acc = L.p_acc_generator(acc, L.s_mul(const_acc, minus1))
    acc = L.p_acc(acc, h_open, L.s_mul(zt_eval, minus1))
    z0_inv = L.s_inv(z_diff_0)
    w_open = L.t_read_point()
    # lhs = u*W' + z0_inv * acc ; check e(W', [s]2) e(-lhs, [1]2) == 1
    return L.final_check(w_open, acc, z0_inv, u)


class NativeLoader:
    """Host-int interpreter: the reference semantics (NativeLoader [dep])."""

    def __init__(self, params, vk: VerifyingKey, instances: list,
                 proof: bytes, transcript_cls):
        self.params = params
        self.vk = vk
        self.instances = instances
        self.t = transcript_cls(proof)

    # scalars
    def s_const(self, v):
        return v % rc.FR

    def s_add(self, a, b):
        return (a + b) % rc.FR

    def s_sub(self, a, b):
        return (a - b) % rc.FR

    def s_mul(self, a, b):
        return a * b % rc.FR

    def s_inv(self, a):
        return rc.finv(a, rc.FR)

    def instance_scalar(self, col, row):
        return self.instances[col][row] % rc.FR

    # transcript
    def t_common_scalar(self, s):
        self.t.common_scalar(s)

    def t_read_scalar(self):
        return self.t.read_scalar()

    def t_read_point(self):
        return self.t.read_point()

    def t_squeeze(self):
        return self.t.squeeze_challenge()

    # points
    def _resolve(self, comm):
        if isinstance(comm, tuple) and comm and comm[0] == "vk_fixed":
            return [(self.vk.fixed_commitments[comm[1]], 1)]
        if isinstance(comm, tuple) and comm and comm[0] == "vk_sigma":
            return [(self.vk.permutation_commitments[comm[1]], 1)]
        if isinstance(comm, tuple) and comm and comm[0] == "h_collapsed":
            _, pts, xn = comm
            return [(pt, pow(xn, i, rc.FR)) for i, pt in enumerate(pts)]
        return [(comm, 1)]

    def p_identity(self):
        return rc.G1_IDENTITY

    def p_acc(self, acc, comm, scalar):
        for pt, c in self._resolve(comm):
            acc = rc.g1_add(acc, rc.g1_mul(rc.g1_from_affine(pt),
                                           scalar * c % rc.FR))
        return acc

    def p_acc_generator(self, acc, scalar):
        return rc.g1_add(acc, rc.g1_mul(rc.g1_from_affine(rc.G1_GEN), scalar))

    def final_check(self, w_open, acc, z0_inv, u) -> bool:
        Lc = rc.g1_mul(acc, z0_inv)
        lhs = rc.g1_to_affine(
            rc.g1_add(rc.g1_mul(rc.g1_from_affine(w_open), u), Lc))
        return rc.pairing_check([
            (w_open, self.params.s_g2),
            (rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(lhs))),
             self.params.g2),
        ])


def verify_proof_core(params, vk: VerifyingKey, instances, proof: bytes,
                      transcript_cls) -> bool:
    """Native verification through the loader-generic core."""
    try:
        loader = NativeLoader(params, vk, instances, proof, transcript_cls)
        return bool(verify_core(loader, vk, [len(c) for c in instances]))
    except ValueError:
        return False
