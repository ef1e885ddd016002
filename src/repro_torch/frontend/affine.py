"""Symbolic quasi-affine arithmetic over grid/block/thread coordinates.

The spec-extraction frontend (DESIGN.md §9) evaluates a Triton kernel's
program ids, loop variables and pointer offsets over *symbols* instead of
integers.  An
``AffineExpr`` is a linear combination of atoms plus an integer constant,
where an atom is a coordinate symbol or one of the quasi-affine forms the
Pallas index-map idiom actually uses:

  * ``FloorDiv(e, c)`` / ``Mod(e, c)`` — grid-dimension packing, e.g. a
    head split ``(h // Hq, h % Hq)`` of one program id;
  * ``Clamp(e, lo, hi)`` — boundary pinning, e.g. ``tl.maximum(t - 2r, 0)``.

Everything the estimator needs — which grid dimensions an address expression
depends on, and exact integer evaluation at any concrete coordinate — is
well-defined for this class.  Anything outside it (symbol×symbol products,
division by a symbol, float coordinates) raises :class:`NonAffineError`
*at the offending operation*, so the tracer can attach the access that broke
the contract.  All arithmetic is overflow-checked against the 64-bit address
range: address expressions that a code generator could not lower to hardware
index arithmetic are rejected rather than silently wrapped.

A copy of ``repro.frontend.affine`` (pure Python and numpy), so that the
port imports nothing of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np

# Addresses must fit hardware index arithmetic; anything beyond this is a
# miscomputed expression, not a real kernel.
_BOUND = 1 << 63


class NonAffineError(TypeError):
    """An operation left the quasi-affine expression class."""


class AffineOverflowError(NonAffineError):
    """An affine coefficient/constant exceeded the 64-bit address range."""


def _checked(v: int) -> int:
    if not (-_BOUND < v < _BOUND):
        raise AffineOverflowError(
            f"affine coefficient {v} exceeds the 64-bit address range")
    return v


@dataclass(frozen=True)
class Sym:
    """A named integer coordinate (grid step, block index, thread index)."""

    name: str

    def _key(self):
        return ("sym", self.name)

    def __repr__(self):
        return self.name


@dataclass(frozen=True)
class FloorDiv:
    expr: "AffineExpr"
    div: int

    def _key(self):
        return ("floordiv", self.expr._key(), self.div)

    def __repr__(self):
        return f"({self.expr!r})//{self.div}"


@dataclass(frozen=True)
class Mod:
    expr: "AffineExpr"
    div: int

    def _key(self):
        return ("mod", self.expr._key(), self.div)

    def __repr__(self):
        return f"({self.expr!r})%{self.div}"


@dataclass(frozen=True)
class Clamp:
    expr: "AffineExpr"
    lo: int | None = None
    hi: int | None = None

    def _key(self):
        return ("clamp", self.expr._key(), self.lo, self.hi)

    def __repr__(self):
        return f"clamp({self.expr!r},{self.lo},{self.hi})"


class SymPredicate:
    """Opaque result of comparing symbolic expressions (e.g. a ``pl.when``
    condition).  Never collapses to a bool — branchy tracing must be decided
    by the tracer, not by Python truthiness."""

    def __init__(self, op: str, lhs, rhs):
        self.op, self.lhs, self.rhs = op, lhs, rhs

    def __bool__(self):
        raise NonAffineError(
            "symbolic comparison used as a concrete bool (data-dependent "
            "Python control flow is not traceable)")


class AffineExpr:
    """``sum(coeff_i * atom_i) + const`` with canonically ordered terms."""

    __slots__ = ("terms", "const")

    def __init__(self, terms=(), const: int = 0):
        if isinstance(terms, dict):
            terms = tuple(
                (a, _checked(c))
                for a, c in sorted(terms.items(), key=lambda kv: kv[0]._key())
                if c != 0
            )
        self.terms = terms
        self.const = _checked(const)

    # ---- structure -----------------------------------------------------
    def _key(self):
        return ("expr", tuple((a._key(), c) for a, c in self.terms), self.const)

    @property
    def is_const(self) -> bool:
        return not self.terms

    def free_syms(self) -> frozenset:
        out = set()
        for atom, _ in self.terms:
            if isinstance(atom, Sym):
                out.add(atom)
            else:
                out |= atom.expr.free_syms()
        return frozenset(out)

    def as_linear(self) -> tuple[dict, int]:
        """``({Sym: coeff}, const)`` — raises unless purely linear."""
        coeffs = {}
        for atom, c in self.terms:
            if not isinstance(atom, Sym):
                raise NonAffineError(
                    f"expression {self!r} is quasi-affine ({atom!r}), "
                    f"not purely linear")
            coeffs[atom] = c
        return coeffs, self.const

    def eval(self, env: Mapping[Sym, int]) -> int:
        """Exact integer value at concrete coordinates (floor semantics)."""
        out = self.const
        for atom, c in self.terms:
            if isinstance(atom, Sym):
                v = env[atom]
            elif isinstance(atom, FloorDiv):
                v = atom.expr.eval(env) // atom.div
            elif isinstance(atom, Mod):
                v = atom.expr.eval(env) % atom.div
            else:  # Clamp
                v = atom.expr.eval(env)
                if atom.lo is not None:
                    v = max(v, atom.lo)
                if atom.hi is not None:
                    v = min(v, atom.hi)
            out += c * v
        return out

    # ---- arithmetic ----------------------------------------------------
    def _combine(self, other, sign: int) -> "AffineExpr":
        other = affine(other)
        terms = dict(self.terms)
        for atom, c in other.terms:
            terms[atom] = terms.get(atom, 0) + sign * c
        return AffineExpr(terms, self.const + sign * other.const)

    def __add__(self, other):
        if not _affine_like(other):
            return NotImplemented
        return self._combine(other, 1)

    __radd__ = __add__

    def __sub__(self, other):
        if not _affine_like(other):
            return NotImplemented
        return self._combine(other, -1)

    def __rsub__(self, other):
        if not _affine_like(other):
            return NotImplemented
        return affine(other)._combine(self, -1)

    def __neg__(self):
        return AffineExpr(
            {a: -c for a, c in self.terms}, -self.const)

    def __mul__(self, other):
        if isinstance(other, AffineExpr):
            if other.is_const:
                other = other.const
            elif self.is_const:
                return other * self.const
            else:
                raise NonAffineError(
                    f"product of two symbolic expressions "
                    f"({self!r}) * ({other!r}) is not affine")
        if isinstance(other, np.integer):
            other = int(other)
        if not isinstance(other, int) or isinstance(other, bool):
            raise NonAffineError(
                f"affine expression multiplied by non-integer {other!r}")
        return AffineExpr(
            {a: _checked(c * other) for a, c in self.terms},
            self.const * other)

    __rmul__ = __mul__

    def _divisor(self, other, op: str) -> int:
        if isinstance(other, AffineExpr) and other.is_const:
            other = other.const
        if isinstance(other, np.integer):
            other = int(other)
        if not isinstance(other, int) or isinstance(other, bool):
            raise NonAffineError(f"{op} of {self!r} by symbolic {other!r}")
        if other <= 0:
            raise NonAffineError(f"{op} of {self!r} by non-positive {other}")
        return other

    def __floordiv__(self, other):
        d = self._divisor(other, "floor division")
        if d == 1:
            return self
        if self.is_const:
            return AffineExpr((), self.const // d)
        if all(c % d == 0 for _, c in self.terms) and self.const % d == 0:
            # exact: distribute (floor(q*d/d) == q for integer atoms)
            return AffineExpr(
                {a: c // d for a, c in self.terms}, self.const // d)
        return AffineExpr({FloorDiv(self, d): 1})

    def __mod__(self, other):
        d = self._divisor(other, "modulo")
        if d == 1:
            return AffineExpr((), 0)
        if all(c % d == 0 for _, c in self.terms):
            # every symbolic term is a multiple of d — only the constant
            # contributes to the residue
            return AffineExpr((), self.const % d)
        return AffineExpr({Mod(self, d): 1})

    def __rfloordiv__(self, other):
        raise NonAffineError(f"division by symbolic expression {self!r}")

    __rmod__ = __rfloordiv__

    def __truediv__(self, other):
        raise NonAffineError(
            f"true division of index expression {self!r} (use //)")

    __rtruediv__ = __truediv__

    # ---- clamping (jnp.maximum / jnp.minimum on index maps) ------------
    def clamp_lo(self, lo: int) -> "AffineExpr":
        if self.is_const:
            return AffineExpr((), max(self.const, lo))
        return AffineExpr({Clamp(self, lo=lo): 1})

    def clamp_hi(self, hi: int) -> "AffineExpr":
        if self.is_const:
            return AffineExpr((), min(self.const, hi))
        return AffineExpr({Clamp(self, hi=hi): 1})

    # ---- comparisons / coercions ---------------------------------------
    def __eq__(self, other):
        """Structural equality (the tracer compares expressions; use
        relational operators for symbolic predicates)."""
        if isinstance(other, int) and not isinstance(other, bool):
            other = AffineExpr((), other)
        if not isinstance(other, AffineExpr):
            return NotImplemented
        return self._key() == other._key()

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._key())

    def __lt__(self, other):
        return SymPredicate("<", self, other)

    def __le__(self, other):
        return SymPredicate("<=", self, other)

    def __gt__(self, other):
        return SymPredicate(">", self, other)

    def __ge__(self, other):
        return SymPredicate(">=", self, other)

    def __bool__(self):
        raise NonAffineError(
            f"symbolic expression {self!r} used as a concrete bool")

    def __int__(self):
        if self.is_const:
            return self.const
        raise NonAffineError(
            f"symbolic expression {self!r} used where a concrete integer "
            f"is required (data-dependent shape or grid?)")

    __index__ = __int__

    def __repr__(self):
        parts = []
        for atom, c in self.terms:
            parts.append(f"{c}*{atom!r}" if c != 1 else f"{atom!r}")
        if self.const or not parts:
            parts.append(str(self.const))
        return " + ".join(parts)


def _affine_like(x) -> bool:
    if isinstance(x, (AffineExpr, Sym, np.integer)):
        return True
    return isinstance(x, int) and not isinstance(x, bool)


def affine(x) -> AffineExpr:
    """Coerce an int / Sym / AffineExpr into an AffineExpr."""
    if isinstance(x, AffineExpr):
        return x
    if isinstance(x, Sym):
        return AffineExpr(((x, 1),))
    if isinstance(x, np.integer):
        return AffineExpr((), int(x))
    if isinstance(x, bool) or not isinstance(x, int):
        raise NonAffineError(
            f"{x!r} ({type(x).__name__}) is not an affine index expression")
    return AffineExpr((), x)


def is_symbolic(x) -> bool:
    return isinstance(x, (AffineExpr, Sym, SymPredicate))
