"""A PLONKish verifier over KZG and SHPLONK in Python ints, which holds a
proof to a verifying key worked out here from the circuit's layout.

The constraint system, its canonical digest, the order of queries and the
verifier's algebra are frozen copies of the proof system the program
implements; the final pairing check uses the SRS's secret tau, which the
benchmark knows (the SRS is its input): e(W, [tau]_2) = e(L', [1]_2)
becomes (tau - u) W = L in G1, the same equation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

from . import bn254 as B
from .bn254 import FR
from .poseidon import TranscriptReader

FIXED, ADVICE, INSTANCE = "fixed", "advice", "instance"


# ---- expressions (the names and fields are part of the circuit's digest) --

class Expr:
    def __add__(self, o):
        return Sum(self, _lift(o))

    def __radd__(self, o):
        return Sum(_lift(o), self)

    def __sub__(self, o):
        return Sum(self, Scaled(_lift(o), -1))

    def __rsub__(self, o):
        return Sum(_lift(o), Scaled(self, -1))

    def __mul__(self, o):
        o = _lift(o)
        return Scaled(self, o.value) if isinstance(o, Constant) \
            else Product(self, o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __neg__(self):
        return Scaled(self, -1)


def _lift(v):
    if isinstance(v, Expr):
        return v
    if isinstance(v, int):
        return Constant(v)
    raise TypeError(f"cannot lift {type(v)}")


@dataclass(frozen=True)
class Constant(Expr):
    value: int

    def degree(self):
        return 0


@dataclass(frozen=True)
class Fixed(Expr):
    index: int
    rotation: int = 0

    def degree(self):
        return 1


@dataclass(frozen=True)
class Advice(Expr):
    index: int
    rotation: int = 0
    phase: int = 0

    def degree(self):
        return 1


@dataclass(frozen=True)
class Instance(Expr):
    index: int
    rotation: int = 0

    def degree(self):
        return 1


@dataclass(frozen=True)
class Challenge(Expr):
    index: int
    phase: int = 0

    def degree(self):
        return 0


@dataclass(frozen=True)
class Sum(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return max(self.a.degree(), self.b.degree())


@dataclass(frozen=True)
class Product(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return self.a.degree() + self.b.degree()


@dataclass(frozen=True)
class Scaled(Expr):
    a: Expr
    scalar: int

    def degree(self):
        return self.a.degree()


def evaluate(e, leaf, cache):
    hit = cache.get(e)
    if hit is not None:
        return hit
    if isinstance(e, Constant):
        v = e.value % FR
    elif isinstance(e, (Fixed, Advice, Instance, Challenge)):
        v = leaf(e)
    elif isinstance(e, Sum):
        v = (evaluate(e.a, leaf, cache) + evaluate(e.b, leaf, cache)) % FR
    elif isinstance(e, Product):
        v = evaluate(e.a, leaf, cache) * evaluate(e.b, leaf, cache) % FR
    elif isinstance(e, Scaled):
        v = evaluate(e.a, leaf, cache) * e.scalar % FR
    else:
        raise TypeError(f"unknown expression {e!r}")
    cache[e] = v
    return v


def _walk_queries(exprs):
    fq, aq, iq = [], [], []

    def walk(e):
        if isinstance(e, (Fixed, Advice, Instance)):
            tgt = fq if isinstance(e, Fixed) else aq \
                if isinstance(e, Advice) else iq
            q = (e.index, e.rotation)
            if q not in tgt:
                tgt.append(q)
        elif isinstance(e, (Sum, Product)):
            walk(e.a)
            walk(e.b)
        elif isinstance(e, Scaled):
            walk(e.a)

    for e in exprs:
        walk(e)
    return fq, aq, iq


@dataclass(frozen=True)
class Column:
    kind: str
    index: int


@dataclass
class Lookup:
    name: str
    pairs: list


@dataclass
class ConstraintSystem:
    num_fixed: int = 0
    num_advice: int = 0
    num_instance: int = 0
    num_challenges: int = 0
    advice_phases: list = field(default_factory=list)
    challenge_phases: list = field(default_factory=list)
    gates: list = field(default_factory=list)
    lookups: list = field(default_factory=list)
    permutation_columns: list = field(default_factory=list)

    def fixed_column(self):
        self.num_fixed += 1
        return Fixed(self.num_fixed - 1)

    def advice_column(self, phase=0):
        self.num_advice += 1
        self.advice_phases.append(phase)
        return Advice(self.num_advice - 1, phase=phase)

    def instance_column(self):
        self.num_instance += 1
        return Instance(self.num_instance - 1)

    def challenge(self, phase=0):
        self.num_challenges += 1
        self.challenge_phases.append(phase)
        return Challenge(self.num_challenges - 1, phase=phase)

    def create_gate(self, name, expr):
        self.gates.append((name, expr))

    def add_lookup(self, name, pairs):
        self.lookups.append(Lookup(name, list(pairs)))

    def enable_permutation(self, col):
        if col not in self.permutation_columns:
            self.permutation_columns.append(col)

    @property
    def num_phases(self):
        return max([p + 1 for p in self.advice_phases] or [1])

    @cached_property
    def queries(self):
        exprs = [g for _, g in self.gates]
        for lk in self.lookups:
            exprs += [p[0] for p in lk.pairs] + [p[1] for p in lk.pairs]
        fq, aq, iq = _walk_queries(exprs)
        for col in self.permutation_columns:
            tgt = {FIXED: fq, ADVICE: aq, INSTANCE: iq}[col.kind]
            if (col.index, 0) not in tgt:
                tgt.append((col.index, 0))
        for i in range(self.num_advice):
            if not any(q[0] == i for q in aq):
                aq.append((i, 0))
        for i in range(self.num_fixed):
            if not any(q[0] == i for q in fq):
                fq.append((i, 0))
        return fq, aq, iq

    def degree(self):
        d = max([g.degree() for _, g in self.gates] or [1])
        for lk in self.lookups:
            ind = max(p[0].degree() for p in lk.pairs)
            tab = max(p[1].degree() for p in lk.pairs)
            d = max(d, 2 + max(ind + 1, tab + 1, 2))
        if self.permutation_columns:
            d = max(d, 3)
        return d

    @property
    def quotient_degree(self):
        return max(self.degree() - 1, 1)

    def chunk_len(self):
        return max(self.degree() - 2, 1)

    def num_chunks(self):
        c = self.chunk_len()
        return (len(self.permutation_columns) + c - 1) // c

    def blinding_factors(self):
        counts = [0] * max(self.num_advice, 1)
        for i, _ in self.queries[1]:
            counts[i] += 1
        return max(counts + [3]) + 2

    def usable_rows(self, n):
        return n - (self.blinding_factors() + 1)

    def digest_bytes(self) -> bytes:
        parts = [f"cs:v1;f={self.num_fixed};a={self.num_advice};"
                 f"i={self.num_instance};c={self.num_challenges};"
                 f"ap={self.advice_phases};cp={self.challenge_phases}"
                 .encode()]
        parts += [f"gate:{nm}:{g!r}".encode() for nm, g in self.gates]
        parts += [f"lookup:{lk.name}:{lk.pairs!r}".encode()
                  for lk in self.lookups]
        parts.append(f"perm:{self.permutation_columns!r}".encode())
        return b"|".join(parts)


@dataclass
class VerifyingKey:
    k: int
    cs: ConstraintSystem
    fixed_commitments: list
    permutation_commitments: list
    num_instance: list

    def transcript_repr(self) -> int:
        parts = [f"vk:v1;k={self.k};ninst={self.num_instance}".encode(),
                 self.cs.digest_bytes()]
        parts += [B.fe_bytes(x) + B.fe_bytes(y) for x, y
                  in self.fixed_commitments + self.permutation_commitments]
        return B.fr_from_wide(B.blake2b(b"|".join(parts), 64,
                                        persona=b"Halo2-Verify-Key"))


# ---- the verifier -----------------------------------------------------------

class _Domain:
    def __init__(self, k):
        self.k, self.n = k, 1 << k
        self.omega = B.root_of_unity(k)
        self.omega_inv = B.finv(self.omega, FR)

    def rot(self, x, r):
        w = self.omega if r >= 0 else self.omega_inv
        return x * pow(w, abs(r), FR) % FR

    def lagrange(self, x, xn, i):
        wi = pow(self.omega, i % self.n, FR)
        return (xn - 1) * wi % FR * B.finv(self.n, FR) % FR \
            * B.finv((x - wi) % FR, FR) % FR


def _bary(values, dom, x):
    xn = pow(x, dom.n, FR)
    acc, wi = 0, 1
    for v in values:
        acc = (acc + v % FR * wi % FR * B.finv((x - wi) % FR, FR)) % FR
        wi = wi * dom.omega % FR
    return (xn - 1) % FR * B.finv(dom.n, FR) % FR * acc % FR


def _expected_h(cs, dom, instances, chal, theta, beta, gamma, y, x, ev):
    n = dom.n
    u_row = n - cs.blinding_factors() - 1
    clen, nch = cs.chunk_len(), cs.num_chunks()
    xn = pow(x, n, FR)
    x_next, x_prev, x_last = dom.rot(x, 1), dom.rot(x, -1), dom.rot(x, u_row)
    fq, aq, _ = cs.queries
    adv = {q: ev(f"advice{q[0]}", dom.rot(x, q[1])) for q in aq}
    fix = {q: ev(f"fixed{q[0]}", dom.rot(x, q[1])) for q in fq}
    inst_cache = {}

    def inst(i, r):
        key = (i, r)
        if key not in inst_cache:
            inst_cache[key] = _bary(instances[i], dom, dom.rot(x, r))
        return inst_cache[key]

    def leaf(e):
        if isinstance(e, Fixed):
            return fix[(e.index, e.rotation)]
        if isinstance(e, Advice):
            return adv[(e.index, e.rotation)]
        if isinstance(e, Instance):
            return inst(e.index, e.rotation)
        return chal[e.index]

    cache: dict = {}
    l0 = dom.lagrange(x, xn, 0)
    l_last = dom.lagrange(x, xn, u_row)
    l_blind = sum(dom.lagrange(x, xn, i) for i in range(u_row + 1, n)) % FR
    active = (1 - l_last - l_blind) % FR
    out = [evaluate(g, leaf, cache) for _, g in cs.gates]
    if nch:
        out.append(l0 * (1 - ev("perm_z0", x)) % FR)
        zl = ev(f"perm_z{nch - 1}", x)
        out.append(l_last * (zl * zl - zl) % FR)
        for c in range(1, nch):
            out.append(l0 * (ev(f"perm_z{c}", x)
                             - ev(f"perm_z{c - 1}", x_last)) % FR)
        for ci in range(nch):
            left, right = ev(f"perm_z{ci}", x_next), ev(f"perm_z{ci}", x)
            for pos, col in enumerate(cs.permutation_columns[ci * clen:
                                                             (ci + 1) * clen]):
                g = ci * clen + pos
                v = adv[(col.index, 0)] if col.kind == ADVICE else \
                    fix[(col.index, 0)] if col.kind == FIXED else \
                    inst(col.index, 0)
                left = left * ((v + beta * ev(f"sigma{g}", x) + gamma) % FR) \
                    % FR
                right = right * ((v + beta * pow(B.DELTA, g, FR) % FR * x
                                  + gamma) % FR) % FR
            out.append(active * (left - right) % FR)
    for li, lk in enumerate(cs.lookups):
        a_comp = s_comp = 0
        for p_in, p_tab in lk.pairs:
            a_comp = (a_comp * theta + evaluate(p_in, leaf, cache)) % FR
        for p_in, p_tab in lk.pairs:
            s_comp = (s_comp * theta + evaluate(p_tab, leaf, cache)) % FR
        z, zn = ev(f"lookup{li}_z", x), ev(f"lookup{li}_z", x_next)
        a_, ap = ev(f"lookup{li}_a", x), ev(f"lookup{li}_a", x_prev)
        s_ = ev(f"lookup{li}_s", x)
        out.append(l0 * (1 - z) % FR)
        out.append(l_last * (z * z - z) % FR)
        lhs = zn * (a_ + beta) % FR * ((s_ + gamma) % FR) % FR
        rhs = z * (a_comp + beta) % FR * ((s_comp + gamma) % FR) % FR
        out.append(active * (lhs - rhs) % FR)
        out.append(l0 * (a_ - s_) % FR)
        out.append(active * (a_ - s_) % FR * ((a_ - ap) % FR) % FR)
    h = 0
    for e in out:
        h = (h * y + e) % FR
    return h * B.finv((xn - 1) % FR, FR) % FR


def _interpolate(points, evals):
    m = len(points)
    coeffs = [0] * m
    for i in range(m):
        denom, basis = 1, [1]
        for j in range(m):
            if j == i:
                continue
            denom = denom * (points[i] - points[j]) % FR
            new = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                new[d + 1] = (new[d + 1] + c) % FR
                new[d] = (new[d] - c * points[j]) % FR
            basis = new
        scale = evals[i] * B.finv(denom, FR) % FR
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % FR
    return coeffs


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % FR
    return acc


def _vanishing(points, u):
    acc = 1
    for p in points:
        acc = acc * ((u - p) % FR) % FR
    return acc


def _scaled(commitment, s):
    """commitment * s in Jacobian form; a commitment is an affine point or
    a list of (affine point, coefficient) terms."""
    if isinstance(commitment, tuple):
        return B.g1_mul(B.g1_from_affine(commitment), s)
    acc = B.G1_IDENTITY
    for pt, c in commitment:
        acc = B.g1_add(acc, B.g1_mul(B.g1_from_affine(pt), c * s % FR))
    return acc


def _shplonk(queries, t, tau) -> bool:
    by_poly, order = {}, []
    for comm, point, value, name in queries:
        if name not in by_poly:
            by_poly[name] = {}
            order.append(name)
        if point in by_poly[name]:
            raise ValueError(f"duplicate query {name}")
        by_poly[name][point] = (comm, value)
    sets, set_order = {}, []
    for name in order:
        pts = tuple(sorted(by_poly[name]))
        if pts not in sets:
            sets[pts] = []
            set_order.append(pts)
        sets[pts].append(by_poly[name])
    super_points = []
    for pts in set_order:
        super_points += [p for p in pts if p not in super_points]
    y = t.squeeze_challenge()
    combined = []
    for pts in set_order:
        P, yk, evs = B.G1_IDENTITY, 1, [0] * len(pts)
        for qmap in sets[pts]:
            P = B.g1_add(P, _scaled(qmap[pts[0]][0], yk))
            for i, p in enumerate(pts):
                evs[i] = (evs[i] + yk * qmap[p][1]) % FR
            yk = yk * y % FR
        combined.append((pts, P, _interpolate(list(pts), evs)))
    v = t.squeeze_challenge()
    h_commit = t.read_point()
    u = t.squeeze_challenge()
    zt = _vanishing(super_points, u)
    L, const, vp, z0 = B.G1_IDENTITY, 0, 1, None
    for pts, P, R in combined:
        zi = _vanishing([p for p in super_points if p not in pts], u)
        z0 = zi if z0 is None else z0
        w = vp * zi % FR
        L = B.g1_add(L, B.g1_mul(P, w))
        const = (const + w * _horner(R, u)) % FR
        vp = vp * v % FR
    L = B.g1_add(L, B.g1_mul(B.g1_from_affine(B.G1_GEN), -const % FR))
    L = B.g1_add(L, B.g1_mul(B.g1_from_affine(h_commit), -zt % FR))
    L = B.g1_mul(L, B.finv(z0, FR))
    w_commit = t.read_point()
    if not t.at_end():
        return False
    # e(W, [tau]_2) * e(-(u W + L), [1]_2) == 1  <=>  (tau - u) W == L
    return B.g1_eq(B.g1_mul(B.g1_from_affine(w_commit), (tau - u) % FR), L)


def verify(vk: VerifyingKey, instances: list, proof: bytes, tau: int) -> bool:
    """True where `proof` is a valid proof of `instances` under `vk`; any
    malformed proof reads False."""
    try:
        return _verify(vk, instances, proof, tau)
    except ValueError:
        return False


def _verify(vk, instances, proof, tau):
    cs = vk.cs
    dom = _Domain(vk.k)
    n = dom.n
    u_row = n - cs.blinding_factors() - 1
    nch = cs.num_chunks()
    fq, aq, _ = cs.queries
    t = TranscriptReader(proof)
    t.common_scalar(vk.transcript_repr())
    for col in instances:
        for v in col:
            t.common_scalar(v)
    adv_c = [None] * cs.num_advice
    chal = {}
    for phase in range(cs.num_phases):
        for i in range(cs.num_advice):
            if cs.advice_phases[i] == phase:
                adv_c[i] = t.read_point()
        for ci, cp in enumerate(cs.challenge_phases):
            if cp == phase:
                chal[ci] = t.squeeze_challenge()
    theta = t.squeeze_challenge()
    lk_perm = [(t.read_point(), t.read_point()) for _ in cs.lookups]
    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    perm_c = [t.read_point() for _ in range(nch)]
    lk_z = [t.read_point() for _ in cs.lookups]
    random_c = t.read_point()
    y = t.squeeze_challenge()
    h_c = [t.read_point() for _ in range(cs.quotient_degree)]
    x = t.squeeze_challenge()
    xn = pow(x, n, FR)
    x_next, x_prev, x_last = dom.rot(x, 1), dom.rot(x, -1), dom.rot(x, u_row)
    adv_e = [t.read_scalar() for _ in aq]
    fix_e = [t.read_scalar() for _ in fq]
    random_e = t.read_scalar()
    sig_e = [t.read_scalar() for _ in cs.permutation_columns]
    pz = [{"x": t.read_scalar(), "next": t.read_scalar()} for _ in range(nch)]
    for c in range(nch - 1):
        pz[c]["last"] = t.read_scalar()
    lk_e = [{k: t.read_scalar() for k in ("z", "z_next", "a", "a_prev", "s")}
            for _ in cs.lookups]
    qs = []
    for j, (i, r) in enumerate(aq):
        qs.append((adv_c[i], dom.rot(x, r), adv_e[j], f"advice{i}"))
    for c in range(nch):
        qs.append((perm_c[c], x, pz[c]["x"], f"perm_z{c}"))
        qs.append((perm_c[c], x_next, pz[c]["next"], f"perm_z{c}"))
        if c != nch - 1:
            qs.append((perm_c[c], x_last, pz[c]["last"], f"perm_z{c}"))
    for li, le in enumerate(lk_e):
        a_c, s_c = lk_perm[li]
        qs += [(lk_z[li], x, le["z"], f"lookup{li}_z"),
               (lk_z[li], x_next, le["z_next"], f"lookup{li}_z"),
               (a_c, x, le["a"], f"lookup{li}_a"),
               (a_c, x_prev, le["a_prev"], f"lookup{li}_a"),
               (s_c, x, le["s"], f"lookup{li}_s")]
    for j, (i, r) in enumerate(fq):
        qs.append((vk.fixed_commitments[i], dom.rot(x, r), fix_e[j],
                   f"fixed{i}"))
    for g in range(len(cs.permutation_columns)):
        qs.append((vk.permutation_commitments[g], x, sig_e[g], f"sigma{g}"))
    qs.append((random_c, x, random_e, "random"))
    evals = {(q[3], q[1]): q[2] for q in qs}
    want_h = _expected_h(cs, dom, instances, chal, theta, beta, gamma, y, x,
                         lambda name, point: evals[(name, point)])
    qs.append(([(pt, pow(xn, i, FR)) for i, pt in enumerate(h_c)], x, want_h,
               "h"))
    return _shplonk(qs, t, tau)


def random_commitment(cs: ConstraintSystem, proof: bytes) -> bytes:
    """The bytes of the vanishing argument's random polynomial's commitment
    in a proof: a fresh blinding stream gives every proof its own."""
    points = cs.num_advice + 2 * len(cs.lookups) + cs.num_chunks() \
        + len(cs.lookups)
    return proof[32 * points:32 * (points + 1)]
