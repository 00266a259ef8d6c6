"""PLONK verifier (host-side, exact ints — verify-only path).

Counterpart of halo2_zkcert_tpu/plonk/verifier.py, on the port's own copy
of the BN254 oracle (utils/refcrypto.py).  Reference behavior: halo2_proofs
`verify_proof` + snark-verifier's NativeLoader verification (deps [dep]
Cargo.lock:1320/2676).

Everything here is O(proof size), not O(n) — host Python ints are fine and
keep the logic obviously-correct.
"""
from __future__ import annotations

from ..utils import refcrypto as rc
from . import expression as ex
from .cs import ADVICE, DELTA, FIXED
from .keygen import VerifyingKey
from .shplonk import VerifierQuery, verify_shplonk


def _barycentric_eval(values: list, n: int, omega: int, x: int) -> int:
    """Evaluate the Lagrange-interpolated poly of `values` (padded with 0)
    at x: p(x) = (x^n - 1)/n * sum_i v_i w^i / (x - w^i)."""
    zh = (pow(x, n, rc.FR) - 1) % rc.FR
    if zh == 0:
        # x in H: p(x) is just the value at that row
        wi = 1
        for i in range(n):
            if x == wi:
                return values[i] % rc.FR if i < len(values) else 0
            wi = wi * omega % rc.FR
        raise AssertionError("unreachable")
    n_inv = rc.finv(n, rc.FR)
    acc = 0
    wi = 1
    for v in values:
        acc = (acc + v % rc.FR * wi % rc.FR
               * rc.finv((x - wi) % rc.FR, rc.FR)) % rc.FR
        wi = wi * omega % rc.FR
    return zh * n_inv % rc.FR * acc % rc.FR


def expected_h(csys, dom, instances: list, challenges: dict, theta: int,
               beta: int, gamma: int, y: int, x: int, ev) -> int:
    """The verifier's h(x): every gate, permutation and lookup constraint
    at x, folded with y and divided by x^n - 1.  `ev(name, point)` is the
    claimed evaluation of the multiopen's polynomial `name` (advice{i},
    fixed{i}, sigma{i}, perm_z{c}, lookup{i}_{z,a,s}) at `point`; the
    instances are evaluated here (they are not committed)."""
    n = dom.n
    u_row = n - csys.blinding_factors() - 1
    chunk_len = csys.permutation_chunk_len()
    num_chunks = csys.num_permutation_chunks()
    xn = pow(x, n, rc.FR)
    x_next = dom.rotate_omega(x, 1)
    x_prev = dom.rotate_omega(x, -1)
    x_last = dom.rotate_omega(x, u_row)

    def instance_eval(i: int, rot: int) -> int:
        return _barycentric_eval(instances[i], n, dom.omega,
                                 dom.rotate_omega(x, rot))

    adv_map = {q: ev(f"advice{q[0]}", dom.rotate_omega(x, q[1]))
               for q in csys.advice_queries}
    fix_map = {q: ev(f"fixed{q[0]}", dom.rotate_omega(x, q[1]))
               for q in csys.fixed_queries}

    def eval_expr(e: ex.Expr) -> int:
        return ex.evaluate(
            e,
            constant=lambda v: v % rc.FR,
            fixed=lambda i, r: fix_map[(i, r)],
            advice=lambda i, r: adv_map[(i, r)],
            instance=instance_eval,
            challenge=lambda i: challenges[i],
            add=lambda a, b: (a + b) % rc.FR,
            mul=lambda a, b: a * b % rc.FR,
            scale=lambda a, s: a * s % rc.FR,
        )

    # l_0, l_last, l_blind at x
    l0 = dom.l_i_range(x, xn, [0])[0]
    l_last = dom.l_i_range(x, xn, [u_row])[0]
    l_blind = sum(dom.l_i_range(x, xn, range(u_row + 1, n))) % rc.FR
    active = (1 - l_last - l_blind) % rc.FR

    exprs = [eval_expr(g) for _, g in csys.gates]

    # permutation constraints (same order as prover.py)
    if num_chunks:
        exprs.append(l0 * (1 - ev("perm_z0", x)) % rc.FR)
        zl = ev(f"perm_z{num_chunks - 1}", x)
        exprs.append(l_last * (zl * zl % rc.FR - zl) % rc.FR)
        for c in range(1, num_chunks):
            exprs.append(l0 * (ev(f"perm_z{c}", x)
                               - ev(f"perm_z{c - 1}", x_last)) % rc.FR)
        for ci in range(num_chunks):
            chunk = csys.permutation_columns[ci * chunk_len:(ci + 1) * chunk_len]
            left = ev(f"perm_z{ci}", x_next)
            right = ev(f"perm_z{ci}", x)
            for pos, col in enumerate(chunk):
                gpos = ci * chunk_len + pos
                if col.kind == ADVICE:
                    v = adv_map[(col.index, 0)]
                elif col.kind == FIXED:
                    v = fix_map[(col.index, 0)]
                else:
                    v = instance_eval(col.index, 0)
                sig = ev(f"sigma{gpos}", x)
                left = left * ((v + beta * sig + gamma) % rc.FR) % rc.FR
                right = right * ((v + beta * pow(DELTA, gpos, rc.FR) % rc.FR * x
                                  + gamma) % rc.FR) % rc.FR
            exprs.append(active * ((left - right) % rc.FR) % rc.FR)

    # lookup constraints
    for li, lk in enumerate(csys.lookups):
        a_comp = 0
        for p_in, _ in lk.pairs:
            a_comp = (a_comp * theta + eval_expr(p_in)) % rc.FR
        s_comp = 0
        for _, p_tab in lk.pairs:
            s_comp = (s_comp * theta + eval_expr(p_tab)) % rc.FR
        z, zn = ev(f"lookup{li}_z", x), ev(f"lookup{li}_z", x_next)
        a_, ap = ev(f"lookup{li}_a", x), ev(f"lookup{li}_a", x_prev)
        s_ = ev(f"lookup{li}_s", x)
        exprs.append(l0 * (1 - z) % rc.FR)
        exprs.append(l_last * (z * z % rc.FR - z) % rc.FR)
        lhs = zn * ((a_ + beta) % rc.FR) % rc.FR * ((s_ + gamma) % rc.FR) \
            % rc.FR
        rhs = z * ((a_comp + beta) % rc.FR) % rc.FR \
            * ((s_comp + gamma) % rc.FR) % rc.FR
        exprs.append(active * ((lhs - rhs) % rc.FR) % rc.FR)
        exprs.append(l0 * ((a_ - s_) % rc.FR) % rc.FR)
        exprs.append(active * ((a_ - s_) % rc.FR) * ((a_ - ap) % rc.FR)
                     % rc.FR)

    h_eval = 0
    for e in exprs:
        h_eval = (h_eval * y + e) % rc.FR
    return h_eval * rc.finv((xn - 1) % rc.FR, rc.FR) % rc.FR


def verify_proof(params, vk: VerifyingKey, instances: list, proof: bytes,
                 transcript_cls) -> bool:
    csys = vk.cs
    dom = vk.domain()
    n = vk.n
    bf = csys.blinding_factors()
    u_row = n - bf - 1
    num_chunks = csys.num_permutation_chunks()
    num_pieces = csys.quotient_degree

    t = transcript_cls(proof)
    t.common_scalar(vk.transcript_repr())
    for col in instances:
        for v in col:
            t.common_scalar(v)

    advice_commits: list = [None] * csys.num_advice
    challenges: dict = {}
    for phase in range(csys.num_phases):
        for i in range(csys.num_advice):
            if csys.advice_phases[i] == phase:
                advice_commits[i] = t.read_point()
        for ci, cp in enumerate(csys.challenge_phases):
            if cp == phase:
                challenges[ci] = t.squeeze_challenge()
    theta = t.squeeze_challenge()
    lookup_permuted = [(t.read_point(), t.read_point()) for _ in csys.lookups]
    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    perm_z_commits = [t.read_point() for _ in range(num_chunks)]
    lookup_z_commits = [t.read_point() for _ in csys.lookups]
    random_commit = t.read_point()
    y = t.squeeze_challenge()
    h_commits = [t.read_point() for _ in range(num_pieces)]
    x = t.squeeze_challenge()
    xn = pow(x, n, rc.FR)

    x_next = dom.rotate_omega(x, 1)
    x_prev = dom.rotate_omega(x, -1)
    x_last = dom.rotate_omega(x, u_row)

    advice_evals = [t.read_scalar() for _ in csys.advice_queries]
    fixed_evals = [t.read_scalar() for _ in csys.fixed_queries]
    random_eval = t.read_scalar()
    num_sigmas = len(csys.permutation_columns)
    sigma_evals = [t.read_scalar() for _ in range(num_sigmas)]
    perm_z = []
    for c in range(num_chunks):
        perm_z.append({"x": t.read_scalar(), "next": t.read_scalar()})
    for c in range(num_chunks - 1):
        perm_z[c]["last"] = t.read_scalar()
    lookup_evals = []
    for _ in csys.lookups:
        lookup_evals.append({
            "z": t.read_scalar(), "z_next": t.read_scalar(),
            "a": t.read_scalar(), "a_prev": t.read_scalar(),
            "s": t.read_scalar(),
        })

    # ---- multiopen queries (same canonical order as prover.py) -----------------
    queries = []

    def q(comm, point, ev, name):
        queries.append(VerifierQuery(commitment=comm, point=point, eval=ev,
                                     name=name))

    for j, (i, r) in enumerate(csys.advice_queries):
        q(advice_commits[i], dom.rotate_omega(x, r), advice_evals[j], f"advice{i}")
    for c in range(num_chunks):
        q(perm_z_commits[c], x, perm_z[c]["x"], f"perm_z{c}")
        q(perm_z_commits[c], x_next, perm_z[c]["next"], f"perm_z{c}")
        if c != num_chunks - 1:
            q(perm_z_commits[c], x_last, perm_z[c]["last"], f"perm_z{c}")
    for li, le in enumerate(lookup_evals):
        a_c, s_c = lookup_permuted[li]
        q(lookup_z_commits[li], x, le["z"], f"lookup{li}_z")
        q(lookup_z_commits[li], x_next, le["z_next"], f"lookup{li}_z")
        q(a_c, x, le["a"], f"lookup{li}_a")
        q(a_c, x_prev, le["a_prev"], f"lookup{li}_a")
        q(s_c, x, le["s"], f"lookup{li}_s")
    for j, (i, r) in enumerate(csys.fixed_queries):
        q(vk.fixed_commitments[i], dom.rotate_omega(x, r), fixed_evals[j],
          f"fixed{i}")
    for gpos in range(num_sigmas):
        q(vk.permutation_commitments[gpos], x, sigma_evals[gpos], f"sigma{gpos}")
    q(random_commit, x, random_eval, "random")

    # h: its expected value at x, against the derived commitment
    # sum x^{n i} [h_i]
    evals = {(vq.name, vq.point): vq.eval for vq in queries}
    want_h = expected_h(csys, dom, instances, challenges, theta, beta, gamma,
                        y, x, lambda name, point: evals[(name, point)])
    h_comm = ("msm", [(pt, pow(xn, i, rc.FR)) for i, pt in enumerate(h_commits)])
    q(h_comm, x, want_h, "h")

    return verify_shplonk(params, queries, t)
