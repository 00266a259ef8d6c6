"""Constraint system description — the static half of a circuit.

Architecture (SURVEY.md §7): a circuit is (a) this static
description — columns, gate polynomials, lookups, the permutation's
equality-constraint list — and (b) a vectorized witness program producing
the advice arrays.  Nothing here touches devices; this is pure metadata the
keygen/prover/verifier consume.

Reference behavior: halo2_proofs `ConstraintSystem` (axiom fork [dep]
Cargo.lock:1320): query collection, degree computation, blinding factors,
permutation argument metadata.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

from ..utils import refcrypto as rc
from . import expression as ex

# Column kinds (for permutation bookkeeping)
FIXED = "fixed"
ADVICE = "advice"
INSTANCE = "instance"
KIND_ORDER = (INSTANCE, ADVICE, FIXED)  # delta-power assignment order


@dataclass(frozen=True)
class Column:
    kind: str
    index: int


@dataclass
class Lookup:
    name: str
    # list of (input_expr, table_expr) pairs, compressed with theta
    pairs: list
    # PROVER HINT (optional): a bound 2^max_bits on every compressed
    # input/table value in the usable rows.  Only valid for single-pair
    # lookups whose expressions are range-bounded (e.g. range-check
    # tables); lets the prover sort on one word and commit the permuted
    # columns with few digit windows.  Not part of the circuit identity.
    max_bits: int | None = None

    def input_degree(self) -> int:
        return max(p[0].degree() for p in self.pairs)

    def table_degree(self) -> int:
        return max(p[1].degree() for p in self.pairs)


@dataclass
class ConstraintSystem:
    num_fixed: int = 0
    num_advice: int = 0
    num_instance: int = 0
    num_challenges: int = 0
    advice_phases: list = field(default_factory=list)     # phase per advice col
    challenge_phases: list = field(default_factory=list)
    gates: list = field(default_factory=list)             # (name, Expr)
    lookups: list = field(default_factory=list)           # Lookup
    permutation_columns: list = field(default_factory=list)  # Column
    # PROVER HINT: advice col index -> bit bound on usable-row values
    # (blinding rows excluded).  Purely an MSM-window optimization; a
    # wrong hint breaks the proof (commitment mismatch), never soundness.
    advice_value_bits: dict = field(default_factory=dict)

    # ---- construction helpers ------------------------------------------------

    def fixed_column(self) -> ex.Fixed:
        self.num_fixed += 1
        return ex.Fixed(self.num_fixed - 1)

    def advice_column(self, phase: int = 0,
                      value_bits: int | None = None) -> ex.Advice:
        self.num_advice += 1
        self.advice_phases.append(phase)
        if value_bits is not None:
            self.advice_value_bits[self.num_advice - 1] = value_bits
        return ex.Advice(self.num_advice - 1, phase=phase)

    def instance_column(self) -> ex.Instance:
        self.num_instance += 1
        return ex.Instance(self.num_instance - 1)

    def challenge(self, phase: int = 0) -> ex.Challenge:
        self.num_challenges += 1
        self.challenge_phases.append(phase)
        return ex.Challenge(self.num_challenges - 1, phase=phase)

    def create_gate(self, name: str, expr: ex.Expr) -> None:
        self.gates.append((name, expr))

    def add_lookup(self, name: str, pairs: list,
                   max_bits: int | None = None) -> None:
        self.lookups.append(Lookup(name, list(pairs), max_bits))

    def enable_permutation(self, col: Column) -> None:
        if col not in self.permutation_columns:
            self.permutation_columns.append(col)

    # ---- derived metadata ------------------------------------------------

    @property
    def num_phases(self) -> int:
        return max([p + 1 for p in self.advice_phases] or [1])

    def gate_exprs(self) -> list:
        return [g for _, g in self.gates]

    @cached_property
    def queries(self) -> tuple:
        """(fixed_queries, advice_queries, instance_queries) — canonical order.

        Collected from gates then lookup inputs then lookup tables; every
        committed column additionally gets a Rotation-0 query so its value is
        part of the multiopen even if no gate references it (halo2 does the
        same for permutation columns).
        """
        exprs = self.gate_exprs()
        for lk in self.lookups:
            exprs.extend(p[0] for p in lk.pairs)
            exprs.extend(p[1] for p in lk.pairs)
        fq, aq, iq = ex.collect_queries(exprs)
        for col in self.permutation_columns:
            target = {FIXED: fq, ADVICE: aq, INSTANCE: iq}[col.kind]
            if (col.index, 0) not in target:
                target.append((col.index, 0))
        # every advice column is committed; ensure at least one query each
        for i in range(self.num_advice):
            if not any(q[0] == i for q in aq):
                aq.append((i, 0))
        for i in range(self.num_fixed):
            if not any(q[0] == i for q in fq):
                fq.append((i, 0))
        return fq, aq, iq

    @property
    def fixed_queries(self):
        return self.queries[0]

    @property
    def advice_queries(self):
        return self.queries[1]

    @property
    def instance_queries(self):
        return self.queries[2]

    def degree(self) -> int:
        """Max constraint degree across gates / lookups / permutation
        (halo2 ConstraintSystem::degree [dep])."""
        d = max([e.degree() for e in self.gate_exprs()] or [1])
        for lk in self.lookups:
            # product rule: (1-(l_last+l_blind)) * (Z(wX)(A'+b)(S'+g) - Z(X)(A)(S))
            d = max(d, 2 + max(lk.input_degree() + 1, lk.table_degree() + 1, 2))
        if self.permutation_columns:
            # chunked product rule degree: chunk_len + 2 <= degree must hold;
            # with chunk_len = degree-2 this is self-consistent; ensure >= 3
            d = max(d, 3)
        return d

    @property
    def quotient_degree(self) -> int:
        return max(self.degree() - 1, 1)

    def permutation_chunk_len(self) -> int:
        return max(self.degree() - 2, 1)

    def num_permutation_chunks(self) -> int:
        c = self.permutation_chunk_len()
        return (len(self.permutation_columns) + c - 1) // c

    def blinding_factors(self) -> int:
        """halo2 formula: max advice queries per column (>=3 for the
        permutation argument), +1 for the random-poly eval, +1 for the
        masked last-row of Z."""
        counts = [0] * max(self.num_advice, 1)
        for (i, _r) in self.advice_queries:
            counts[i] += 1
        factors = max(counts + [3])
        return factors + 2

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors() + 1)

    # ---- serialization (vk metadata) ------------------------------------

    def to_dict(self) -> dict:
        """Pickle-free structural encoding (JSON-safe).

        Expressions are flattened into a shared node table (index-linked)
        so hash-consed subtrees serialize once and deserialize back to
        shared objects.  Replaces the hex-pickle the vk/snark artifacts
        carried through round 4 (unpickling attacker-supplied proof files
        is an arbitrary-code-execution hazard; reference snark files are
        plain bincode data, snark-verifier-sdk [dep] Cargo.lock:2714).
        """
        nodes: list = []
        index: dict = {}

        def enc(e: ex.Expr) -> int:
            i = index.get(e)
            if i is not None:
                return i
            if isinstance(e, ex.Constant):
                node = ["c", str(e.value)]
            elif isinstance(e, ex.Fixed):
                node = ["f", e.index, e.rotation]
            elif isinstance(e, ex.Advice):
                node = ["a", e.index, e.rotation, e.phase]
            elif isinstance(e, ex.Instance):
                node = ["i", e.index, e.rotation]
            elif isinstance(e, ex.Challenge):
                node = ["ch", e.index, e.phase]
            elif isinstance(e, ex.Sum):
                node = ["+", enc(e.a), enc(e.b)]
            elif isinstance(e, ex.Product):
                node = ["*", enc(e.a), enc(e.b)]
            elif isinstance(e, ex.Scaled):
                node = ["s", enc(e.a), str(e.scalar)]
            else:
                raise TypeError(f"cannot serialize expr {e!r}")
            nodes.append(node)
            i = len(nodes) - 1
            index[e] = i
            return i

        return {
            "num_fixed": self.num_fixed,
            "num_advice": self.num_advice,
            "num_instance": self.num_instance,
            "num_challenges": self.num_challenges,
            "advice_phases": list(self.advice_phases),
            "challenge_phases": list(self.challenge_phases),
            "nodes": nodes,
            "gates": [[name, enc(g)] for name, g in self.gates],
            "lookups": [[lk.name,
                         [[enc(a), enc(b)] for a, b in lk.pairs],
                         lk.max_bits] for lk in self.lookups],
            "permutation_columns": [[c.kind, c.index]
                                    for c in self.permutation_columns],
            "advice_value_bits": {str(k): v
                                  for k, v in self.advice_value_bits.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "ConstraintSystem":
        raw = d["nodes"]
        built: list = [None] * len(raw)

        def dec(i: int) -> ex.Expr:
            if built[i] is not None:
                return built[i]
            n = raw[i]
            tag = n[0]
            if tag == "c":
                e = ex.Constant(int(n[1]))
            elif tag == "f":
                e = ex.Fixed(int(n[1]), int(n[2]))
            elif tag == "a":
                e = ex.Advice(int(n[1]), int(n[2]), int(n[3]))
            elif tag == "i":
                e = ex.Instance(int(n[1]), int(n[2]))
            elif tag == "ch":
                e = ex.Challenge(int(n[1]), int(n[2]))
            elif tag == "+":
                e = ex.Sum(dec(int(n[1])), dec(int(n[2])))
            elif tag == "*":
                e = ex.Product(dec(int(n[1])), dec(int(n[2])))
            elif tag == "s":
                e = ex.Scaled(dec(int(n[1])), int(n[2]))
            else:
                raise ValueError(f"unknown expr node tag {tag!r}")
            built[i] = e
            return e

        # children precede parents in the table; recursion on deep gate
        # trees would blow the stack, so decode in table order instead
        for i in range(len(raw)):
            dec(i)
        return ConstraintSystem(
            num_fixed=int(d["num_fixed"]),
            num_advice=int(d["num_advice"]),
            num_instance=int(d["num_instance"]),
            num_challenges=int(d["num_challenges"]),
            advice_phases=[int(p) for p in d["advice_phases"]],
            challenge_phases=[int(p) for p in d["challenge_phases"]],
            gates=[(name, built[int(gi)]) for name, gi in d["gates"]],
            lookups=[Lookup(name,
                            [(built[int(a)], built[int(b)]) for a, b in pairs],
                            max_bits)
                     for name, pairs, max_bits in d["lookups"]],
            permutation_columns=[Column(kind, int(idx))
                                 for kind, idx in d["permutation_columns"]],
            advice_value_bits={int(k): int(v)
                               for k, v in d["advice_value_bits"].items()},
        )

    def digest_bytes(self) -> bytes:
        """Canonical byte encoding of the whole CS for vk hashing."""
        parts = [
            f"cs:v1;f={self.num_fixed};a={self.num_advice};i={self.num_instance}"
            f";c={self.num_challenges};ap={self.advice_phases}"
            f";cp={self.challenge_phases}".encode()
        ]
        for name, g in self.gates:
            parts.append(f"gate:{name}:{g!r}".encode())
        for lk in self.lookups:
            parts.append(f"lookup:{lk.name}:{lk.pairs!r}".encode())
        parts.append(f"perm:{self.permutation_columns!r}".encode())
        return b"|".join(parts)


# delta for the permutation argument: generator of the order-t subgroup,
# delta = g^(2^S) (ff `PrimeField::DELTA` for BN254 Fr [dep halo2curves]).
DELTA = pow(rc.FR_GENERATOR, 1 << rc.FR_TWO_ADICITY, rc.FR)
