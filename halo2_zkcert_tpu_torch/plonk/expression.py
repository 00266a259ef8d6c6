"""Polynomial expression AST for PLONKish gates.

Mirrors halo2_proofs `Expression` (axiom fork [dep] Cargo.lock:1320), minus
the `Selector` variant: selectors are plain fixed columns here (the same
choice halo2-base circuits effectively make — every gate is toggled by a
fixed `q` column), which keeps the array pipeline uniform.

Expressions are evaluated in two places:
* quotient construction: over the extended coset domain, vectorized on
  device (each leaf an (ext_n, 8) tensor, rotation = torch.roll);
* verification: at the challenge point x, host-side Python ints.

Both use the same `evaluate` tree-walk with pluggable leaf/op callbacks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


class Expr:
    def __add__(self, other):
        return Sum(self, _lift(other))

    def __radd__(self, other):
        return Sum(_lift(other), self)

    def __sub__(self, other):
        return Sum(self, Scaled(_lift(other), -1))

    def __rsub__(self, other):
        return Sum(_lift(other), Scaled(self, -1))

    def __mul__(self, other):
        other = _lift(other)
        if isinstance(other, Constant):
            return Scaled(self, other.value)
        return Product(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return Scaled(self, -1)

    def degree(self) -> int:
        raise NotImplementedError


def _lift(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    if isinstance(v, int):
        return Constant(v)
    raise TypeError(f"cannot lift {type(v)} to Expr")


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


def evaluate(expr: Expr, *, constant: Callable, fixed: Callable,
             advice: Callable, instance: Callable, challenge: Callable,
             add: Callable, mul: Callable, scale: Callable,
             _cache: dict | None = None) -> Any:
    """Generic tree-walk with node-level memoization (expressions are
    hash-consed dataclasses, so shared subtrees evaluate once)."""
    cache = _cache if _cache is not None else {}

    def go(e: Expr):
        hit = cache.get(e)
        if hit is not None:
            return hit
        if isinstance(e, Constant):
            v = constant(e.value)
        elif isinstance(e, Fixed):
            v = fixed(e.index, e.rotation)
        elif isinstance(e, Advice):
            v = advice(e.index, e.rotation)
        elif isinstance(e, Instance):
            v = instance(e.index, e.rotation)
        elif isinstance(e, Challenge):
            v = challenge(e.index)
        elif isinstance(e, Sum):
            v = add(go(e.a), go(e.b))
        elif isinstance(e, Product):
            v = mul(go(e.a), go(e.b))
        elif isinstance(e, Scaled):
            v = scale(go(e.a), e.scalar)
        else:
            raise TypeError(f"unknown expr {e}")
        cache[e] = v
        return v

    # `go` refers to itself: left alone, it and the memo (device tensors in
    # the prover) would live until the cyclic collector runs, so the memory
    # a proof holds would depend on when that happens
    try:
        return go(expr)
    finally:
        del go


def collect_queries(exprs) -> tuple:
    """All (index, rotation) leaf queries, per column kind, in first-seen
    order — the canonical query ordering used by prover & verifier."""
    fixed_q, advice_q, instance_q = [], [], []

    def walk(e: Expr):
        if isinstance(e, Fixed):
            q = (e.index, e.rotation)
            if q not in fixed_q:
                fixed_q.append(q)
        elif isinstance(e, Advice):
            q = (e.index, e.rotation)
            if q not in advice_q:
                advice_q.append(q)
        elif isinstance(e, Instance):
            q = (e.index, e.rotation)
            if q not in instance_q:
                instance_q.append(q)
        elif isinstance(e, (Sum, Product)):
            walk(e.a)
            walk(e.b)
        elif isinstance(e, Scaled):
            walk(e.a)

    for e in exprs:
        walk(e)
    return fixed_q, advice_q, instance_q
