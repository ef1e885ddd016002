"""Symbolic tracing of Triton kernels into address-expression artifacts.

``trace_kernel`` runs a *launcher* (the closure a user writes around
``kernel[grid](..., BLOCK=...)``) with shape-only ``meta`` tensors for its
placeholder arguments, inside a patch context that intercepts the one
Triton launch it makes.  Nothing is compiled and no memory is touched;
instead the kernel's Python body runs once (see below for a loop) over
symbolic values and the trace captures the artifact the estimator
requires from a code generator (paper §1.2), in the reference's IR
(``repro.frontend.trace``):

  * the launch structure — the grid, one operand per pointer argument with
    its block (the bounding box of its windows in one program), the
    accumulator a loop carries (the TPU's scratch);
  * per operand, the **address expression**: ``tl.program_id(d)`` is the
    grid symbol ``g{d}``, ``tl.arange`` a lane, and a pointer argument plus
    an offset tensor one window of that argument, split into per-dimension
    origins (affine in the grid symbols) and extents by the argument's
    strides;
  * the body's loads and stores (``BodyAccess``), ``tl.dot`` products
    (``BodyMatmul``) and the elements its elementwise ops and reductions
    touch — enough to lower thread-level affine maps for the GPU estimator
    and to derive default cost models.

One loop over a compile-time range (``range``, ``tl.range``,
``tl.static_range``) becomes a trailing grid dimension of extent
``ceil((hi - lo) / step)``, the reference's sequential reduction axis: its
body runs twice over one symbolic loop variable, the first pass recorded
and the second compared with it, so a pointer or offset the loop advances
by a constant step gets that step times the loop symbol.  Masks and
``other=`` leave a window as it is (the reference's ``pl.when`` traces both
sides the same way).

A launch is intercepted the way the reference patches ``pl.pallas_call``:
``triton.runtime.jit.JITFunction.__getitem__`` when Triton is installed,
the stand-in ``repro_torch.frontend.tl.jit`` otherwise, and in the kernel's
globals every binding of ``triton.language`` (by identity, or named
``tl``) is swapped for the stand-in, whose functions act on the trace.
Kernels outside the affine contract are rejected with a diagnostic naming
the offending argument (``TraceError``), which the exploration engine
surfaces as a ``report.skipped`` reason rather than a crash.

Importing this module imports neither torch nor triton; tracing does.
"""
from __future__ import annotations

import inspect
import math
import types
from dataclasses import dataclass, field as dc_field

import numpy as np

from .affine import (
    AffineExpr,
    Clamp,
    FloorDiv,
    Mod,
    NonAffineError,
    Sym,
    affine,
)


class TraceError(RuntimeError):
    """A kernel (or one access of it) is outside the traceable contract."""

    def __init__(self, kernel: str, where: str, reason: str):
        self.kernel = kernel
        self.where = where
        self.reason = reason
        super().__init__(f"{kernel}: {where}: {reason}")


def _itemsize(dtype) -> int:
    if type(dtype).__module__ == "torch":
        return int(dtype.itemsize)
    return int(np.dtype(dtype).itemsize)


@dataclass(frozen=True)
class Placeholder:
    """Shape/dtype stand-in for one launcher argument (a torch or numpy
    dtype)."""

    name: str
    shape: tuple
    dtype: object = np.float32

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def elem_bytes(self) -> int:
        return _itemsize(self.dtype)


def arg(name: str, shape, dtype=np.float32) -> Placeholder:
    """Declare a traced-kernel argument (a torch or numpy dtype)."""
    return Placeholder(name, tuple(int(s) for s in shape), dtype)


def grid_sym(d: int) -> Sym:
    """The canonical symbol for grid dimension ``d``."""
    return Sym(f"g{d}")


# --------------------------------------------------------------------------
# trace result structures (the reference's IR)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class TracedOperand:
    """One operand with its evaluated address expression."""

    name: str
    block_shape: tuple
    elem_bytes: int
    index_exprs: tuple          # per block dim: AffineExpr over grid syms
    grid_deps: tuple            # grid dims the index map depends on
    is_output: bool
    arg_name: str               # underlying array argument
    arg_shape: tuple            # full array shape (field size)
    arg_pos: int                # identity of the underlying argument


@dataclass(frozen=True)
class TracedScratch:
    shape: tuple
    elem_bytes: int

    def nbytes(self) -> int:
        return math.prod(self.shape) * self.elem_bytes


@dataclass
class BodyAccess:
    """One load/store the kernel body performed, in block coordinates."""

    ref_kind: str               # "op" | "scratch"
    ref_index: int
    offsets: tuple              # per ref dim: AffineExpr | int
    extents: tuple              # per ref dim: int
    is_store: bool = False


@dataclass
class BodyMatmul:
    m: int
    k: int
    n: int
    lhs: BodyAccess | None = None
    rhs: BodyAccess | None = None


@dataclass
class TracedBody:
    """Digest of one symbolic kernel-body execution.  ``masked`` (the
    port's addition) holds the indices into ``accesses`` of the loads and
    stores that carried a mask or ``other=``; their windows are as
    unmasked."""

    ok: bool = False
    error: str | None = None
    accesses: list = dc_field(default_factory=list)   # ordered BodyAccess
    matmuls: list = dc_field(default_factory=list)    # ordered BodyMatmul
    elementwise_elems: float = 0.0
    notes: list = dc_field(default_factory=list)
    masked: list = dc_field(default_factory=list)

    def loads(self, kind: str | None = None):
        return [a for a in self.accesses
                if not a.is_store and (kind is None or a.ref_kind == kind)]

    def stores(self, kind: str | None = None):
        return [a for a in self.accesses
                if a.is_store and (kind is None or a.ref_kind == kind)]

    def scratch_accesses(self):
        return [a for a in self.accesses if a.ref_kind == "scratch"]


@dataclass
class TracedKernel:
    """Everything ``trace_kernel`` extracted from one launch."""

    name: str
    grid: tuple
    operands: tuple             # tuple[TracedOperand, ...], inputs then outputs
    scratch: tuple              # tuple[TracedScratch, ...]
    body: TracedBody

    @property
    def inputs(self):
        return tuple(o for o in self.operands if not o.is_output)

    @property
    def outputs(self):
        return tuple(o for o in self.operands if o.is_output)

    def scratch_bytes(self) -> int:
        return sum(s.nbytes() for s in self.scratch)

    def points_per_step(self) -> int:
        """Output elements written per grid step (work-unit default)."""
        return sum(math.prod(o.block_shape) for o in self.outputs)


# --------------------------------------------------------------------------
# symbolic body values
# --------------------------------------------------------------------------
_CTX: "_Trace | None" = None


def _ctx() -> "_Trace":
    if _CTX is None:
        raise RuntimeError("a traced kernel value was used outside its trace")
    return _CTX


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _broadcast(*shapes) -> tuple:
    try:
        return tuple(np.broadcast_shapes(*shapes))
    except ValueError as e:
        raise TraceError(_ctx().name, "kernel body",
                         f"shapes {shapes} do not broadcast: {e}") from e


def _expand(shape: tuple, idx, what: str):
    """``x[:, None]``-style indexing: the new shape and, per old axis, its
    new position."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    if any(i is Ellipsis for i in idx):
        pos = idx.index(Ellipsis)
        kept = sum(1 for i in idx if i is not None and i is not Ellipsis)
        idx = idx[:pos] + (slice(None),) * (len(shape) - kept) + idx[pos + 1:]
    new, where, axis = [], {}, 0
    for i in idx:
        if i is None:
            new.append(1)
        elif isinstance(i, slice) and i == slice(None):
            if axis >= len(shape):
                break
            where[axis] = len(new)
            new.append(shape[axis])
            axis += 1
        else:
            raise TraceError(_ctx().name, "kernel body",
                             f"indexing {what} with {i!r} is not traceable "
                             f"(only [:, None] broadcasting is)")
    for a in range(axis, len(shape)):
        where[a] = len(new)
        new.append(shape[a])
    return tuple(new), where


class Index:
    """An integer value that can become an address: ``base`` (affine in the
    grid symbols) plus, per lane ``(uid, extent, axis, coef)``, ``coef``
    times the lane's position along ``axis`` of ``shape``."""

    __slots__ = ("shape", "base", "lanes")

    def __init__(self, shape=(), base=0, lanes=()):
        self.shape = tuple(shape)
        self.base = affine(base)
        self.lanes = tuple(lanes)

    dtype = property(lambda self: _standin().int32)

    def _lane_free_const(self):
        return not self.lanes and self.base.is_const

    def value_range(self) -> tuple:
        lo, hi = _expr_range(self.base)
        for _uid, n, _axis, c in self.lanes:
            lo += min(0, c * (n - 1))
            hi += max(0, c * (n - 1))
        return lo, hi

    def __getitem__(self, idx):
        shape, where = _expand(self.shape, idx, "an index")
        return Index(shape, self.base,
                     tuple((u, n, where[a], c) for u, n, a, c in self.lanes))

    def to(self, dtype, **_kw):
        if _dtype_name(dtype).startswith(("int", "uint")):
            return self
        return Tile(self.shape, dtype)

    def __neg__(self):
        return Index(self.shape, -self.base,
                     tuple((u, n, a, -c) for u, n, a, c in self.lanes))

    def __pos__(self):
        return self

    def __bool__(self):
        raise NonAffineError(
            f"traced index {self!r} used as a concrete bool (data-dependent "
            f"Python control flow is not traceable)")

    def __int__(self):
        if self._lane_free_const():
            return self.base.const
        raise NonAffineError(
            f"traced index {self!r} used where a concrete integer is required "
            f"(a loop bound or shape that depends on the program id?)")

    __index__ = __int__

    def __repr__(self):
        lanes = " + ".join(f"{c}*lane{u}[{n}]" for u, n, _a, c in self.lanes)
        return f"{self.base!r}" + (f" + {lanes}" if lanes else "")


class Poison:
    """An integer value outside the affine class: harmless as data or in a
    mask, a ``TraceError`` naming the argument once it reaches a pointer."""

    __slots__ = ("shape", "reason")

    def __init__(self, shape, reason: str):
        self.shape = tuple(shape)
        self.reason = reason

    def __getitem__(self, idx):
        return Poison(_expand(self.shape, idx, "an index")[0], self.reason)

    def to(self, dtype, **_kw):
        return self if _dtype_name(dtype).startswith(("int", "uint")) \
            else Tile(self.shape, dtype)

    def __neg__(self):
        return self

    def __bool__(self):
        raise NonAffineError(self.reason)

    __int__ = __index__ = __bool__


class Mask:
    """The result of comparing addresses: a predicate, never a bool."""

    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __getitem__(self, idx):
        return Mask(_expand(self.shape, idx, "a mask")[0])

    def __invert__(self):
        return self

    def to(self, dtype, **_kw):
        return Tile(self.shape, dtype)

    def __bool__(self):
        raise NonAffineError(
            "symbolic comparison used as a concrete bool (data-dependent "
            "Python control flow is not traceable)")


class Tile:
    """A value the body computes: its shape, dtype, the load behind it
    (``access``, an index into the trace's raw accesses), the scratch
    index of the accumulator it is a value of (``acc``), and whether it is
    a ``tl.zeros``/``tl.full`` made before the loop (``init``)."""

    __slots__ = ("shape", "dtype", "access", "acc", "init")

    def __init__(self, shape, dtype, access=None, acc=None, init=False):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.access = access
        self.acc = acc
        self.init = init

    @property
    def T(self):
        return _ctx().trans(self)

    def to(self, dtype, **_kw):
        # a pure cast: keep the load behind it, count nothing
        return Tile(self.shape, dtype, self.access, self.acc, self.init)

    def __getitem__(self, idx):
        shape = _expand(self.shape, idx, "a tensor")[0]
        return Tile(shape, self.dtype, self.access, self.acc, self.init)

    def sum(self, axis=None, keep_dims=False, **_kw):
        return _ctx().reduce(self, axis, keep_dims)

    max = min = sum

    def __neg__(self):
        return _ctx().tile_op(self, 0.0, count=True)

    __abs__ = __invert__ = __neg__

    def __bool__(self):
        raise NonAffineError(
            "traced tensor used as a concrete bool (data-dependent control "
            "flow is not traceable)")

    def __repr__(self):
        return f"Tile(shape={self.shape}, loaded={self.access is not None})"


class Pointer:
    """A pointer argument plus an offset: one window of that argument."""

    __slots__ = ("param", "offset", "loop_born")

    def __init__(self, param, offset, loop_born=False):
        self.param = param
        self.offset = offset
        self.loop_born = loop_born

    shape = property(lambda self: self.offset.shape)
    dtype = property(lambda self: _PointerType(self.param.dtype))

    def __getitem__(self, idx):
        return Pointer(self.param, self.offset[idx], self.loop_born)

    def __bool__(self):
        raise NonAffineError("a pointer used as a concrete bool")

    def __repr__(self):
        return f"Pointer({self.param.name!r} + {self.offset!r})"


class _PointerType:
    def __init__(self, torch_dtype):
        self.element_ty = _standin().dtype_of(torch_dtype)


def _standin():
    from . import tl

    return tl


def _dtype_name(d) -> str:
    name = getattr(d, "name", None)
    if isinstance(name, str):
        return name
    return str(d).replace("torch.", "")


def _dtype_bytes(d) -> int:
    if hasattr(d, "itemsize") and not isinstance(d, type):
        return int(d.itemsize)
    bits = getattr(d, "primitive_bitwidth", None)
    if bits:
        return max(1, int(bits) // 8)
    return 4


def _expr_range(e: AffineExpr) -> tuple:
    """The least and largest value of ``e`` over the trace's grid."""
    ctx = _ctx()
    lo = hi = e.const
    for atom, c in e.terms:
        alo, ahi = _atom_range(ctx, atom)
        lo += min(c * alo, c * ahi)
        hi += max(c * alo, c * ahi)
    return lo, hi


def _atom_range(ctx, atom) -> tuple:
    if isinstance(atom, Sym):
        return 0, ctx.extent.get(atom, 1) - 1
    lo, hi = _expr_range(atom.expr)
    if isinstance(atom, FloorDiv):
        return lo // atom.div, hi // atom.div
    if isinstance(atom, Mod):
        if 0 <= lo and hi < atom.div:
            return lo, hi
        return 0, atom.div - 1
    if isinstance(atom, Clamp):
        if atom.lo is not None:
            lo, hi = max(lo, atom.lo), max(hi, atom.lo)
        if atom.hi is not None:
            lo, hi = min(lo, atom.hi), min(hi, atom.hi)
        return lo, hi
    raise NonAffineError(f"no range for {atom!r}")


def _merge_lanes(a: Index, b: Index, n: int, sign: int):
    out = {}
    for u, ext, ax, c in a.lanes:
        out[u] = [ext, ax + n - len(a.shape), c]
    for u, ext, ax, c in b.lanes:
        ax += n - len(b.shape)
        if u in out:
            if out[u][1] != ax:
                return None
            out[u][2] += sign * c
        else:
            out[u] = [ext, ax, sign * c]
    return tuple((u, e, ax, c) for u, (e, ax, c) in out.items() if c)


def _as_index(x):
    if isinstance(x, Index):
        return x
    if isinstance(x, (AffineExpr, Sym)) or _is_int(x):
        return Index((), affine(x))
    return None


def _index_op(op: str, a: Index, b: Index):
    """Integer arithmetic on addresses: affine where it can be."""
    n_shape = _broadcast(a.shape, b.shape)
    if op in ("add", "sub"):
        sign = 1 if op == "add" else -1
        lanes = _merge_lanes(a, b, len(n_shape), sign)
        if lanes is None:
            return Poison(n_shape, "one lane along two axes is not an affine "
                                   "address")
        base = a.base + b.base if sign > 0 else a.base - b.base
        return Index(n_shape, base, lanes)
    if op == "mul":
        if b._lane_free_const():
            a, b = b, a
        if a._lane_free_const():
            k = a.base.const
            return Index(n_shape, b.base * k,
                         tuple((u, e, ax + len(n_shape) - len(b.shape), c * k)
                               for u, e, ax, c in b.lanes if c * k))
        return Poison(n_shape, f"product of two symbolic indices ({a!r}) * "
                               f"({b!r}) is not affine")
    if op in ("floordiv", "mod"):
        if not b._lane_free_const():
            return Poison(n_shape, f"{op} of {a!r} by symbolic {b!r} is not "
                                   f"affine")
        d = b.base.const
        if d <= 0:
            return Poison(n_shape, f"{op} of {a!r} by non-positive {d}")
        lo, hi = a.value_range()
        if op == "mod":
            if 0 <= lo and hi < d:
                return a
            if not a.lanes:
                return Index(n_shape, a.base % d)
            return Poison(n_shape, f"({a!r}) % {d} wraps lanes: not affine")
        if all(c % d == 0 for *_x, c in a.lanes) and \
                all(c % d == 0 for _atom, c in a.base.terms) and \
                a.base.const % d == 0:
            return Index(n_shape, a.base // d,
                         tuple((u, e, ax, c // d) for u, e, ax, c in a.lanes))
        if 0 <= lo and hi < d:
            return Index(n_shape, 0)
        if not a.lanes:
            return Index(n_shape, a.base // d)
        return Poison(n_shape, f"({a!r}) // {d} splits lanes: not affine")
    if op in ("lshift", "rshift") and b._lane_free_const():
        k = 2 ** b.base.const
        return _index_op("mul" if op == "lshift" else "floordiv", a,
                         Index((), k))
    if op == "truediv":
        return Tile(n_shape, _standin().float32)
    return Poison(n_shape, f"{op} of two indices is not an affine address")


_CMP = {"lt", "le", "gt", "ge", "eq", "ne"}
_LOGIC = {"and", "or", "xor"}


def _shape_of(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def _binary(op: str, a, b):
    """Every binary operator of the traced values, in one place."""
    ctx = _ctx()
    if isinstance(b, Pointer) and op == "add":
        a, b = b, a
    if isinstance(a, Pointer) or isinstance(b, Pointer):
        if not isinstance(a, Pointer) or op not in ("add", "sub") or \
                isinstance(b, Pointer):
            raise TraceError(ctx.name, "kernel body",
                             f"{op} of {a!r} and {b!r} is not pointer "
                             f"arithmetic the tracer follows")
        return ctx.advance(a, b, op)
    if isinstance(a, Tile) or isinstance(b, Tile):
        return ctx.tile_op(a, b, count=op not in _CMP)
    if isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        return ctx.tile_op(a, b, count=op not in _CMP)
    if isinstance(a, Mask) or isinstance(b, Mask):
        shape = _broadcast(_shape_of(a), _shape_of(b))
        if op in _LOGIC or op in _CMP:
            return Mask(shape)
        return ctx.tile_op(a, b, count=True)
    if isinstance(a, Poison) or isinstance(b, Poison):
        shape = _broadcast(_shape_of(a), _shape_of(b))
        if op in _CMP:
            return Mask(shape)
        return Poison(shape, (a if isinstance(a, Poison) else b).reason)
    ia, ib = _as_index(a), _as_index(b)
    if ia is None or ib is None:
        raise TraceError(ctx.name, "kernel body",
                         f"{op} of {a!r} and {b!r} is not traceable")
    if op in _CMP:
        return Mask(_broadcast(ia.shape, ib.shape))
    if op in _LOGIC:
        return Poison(_broadcast(ia.shape, ib.shape),
                      f"bitwise {op} of indices is not an affine address")
    return _index_op(op, ia, ib)


_PY_OPS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "truediv": lambda a, b: a / b,
    "floordiv": lambda a, b: a // b, "mod": lambda a, b: a % b,
    "pow": lambda a, b: a ** b,
}


def _install_operators():
    names = {"add": "add", "sub": "sub", "mul": "mul", "truediv": "truediv",
             "floordiv": "floordiv", "mod": "mod", "and": "and", "or": "or",
             "xor": "xor", "lshift": "lshift", "rshift": "rshift",
             "pow": "pow"}
    for cls in (Index, Poison, Mask, Tile, Pointer):
        for dunder, op in names.items():
            setattr(cls, f"__{dunder}__",
                    lambda self, other, _op=op: _binary(_op, self, other))
            setattr(cls, f"__r{dunder}__",
                    lambda self, other, _op=op: _binary(_op, other, self))
        for op, flipped in (("lt", "gt"), ("le", "ge"), ("gt", "lt"),
                            ("ge", "le"), ("eq", "eq"), ("ne", "ne")):
            setattr(cls, f"__{op}__",
                    lambda self, other, _op=op: _binary(_op, self, other))
        cls.__hash__ = None


_install_operators()


# --------------------------------------------------------------------------
# the trace context
# --------------------------------------------------------------------------
class _Param:
    """One pointer argument of the launch."""

    __slots__ = ("pos", "name", "placeholder", "shape", "strides", "dtype",
                 "elem_bytes", "windows")

    def __init__(self, pos, name, placeholder, tensor):
        self.pos = pos
        self.name = name
        self.placeholder = placeholder
        self.shape = tuple(int(s) for s in tensor.shape)
        self.strides = tuple(int(s) for s in tensor.stride())
        self.dtype = tensor.dtype
        self.elem_bytes = int(tensor.element_size())
        self.windows = []           # (raw access index, origins, extents)


class _Raw:
    """One load or store as the body made it, before its window is split."""

    __slots__ = ("kind", "ref", "offset", "store", "masked", "phase")

    def __init__(self, kind, ref, offset, store, masked, phase):
        self.kind, self.ref, self.offset = kind, ref, offset
        self.store, self.masked, self.phase = store, masked, phase


class _Trace:
    def __init__(self, name: str, args):
        self.name = name
        self.args = args                      # Placeholders (by position)
        self.metas = ()                       # their meta tensors
        self.launch = None                    # (kernel, fn, grid, args, kwargs)
        self.body = TracedBody()
        self.params = []
        self.grid = ()
        self.extent = {}                      # Sym -> extent
        self.loop_dim = None                  # (sym, extent) of the loop
        self.phase = None                     # None | "A" | "B" | "after"
        self.raw, self.raw_b = [], []
        self.scratch = []                     # TracedScratch, by index
        self.funcs = {}                       # id(fn) -> rewritten function
        self.lanes = 0                        # the next lane's id

    # ---- launch capture --------------------------------------------------
    def launcher(self, kernel, fn, grid):
        def launch(*args, **kwargs):
            if self.launch is not None:
                raise TraceError(self.name, "launch",
                                 "the launcher launched more than one kernel "
                                 "(trace one kernel per launcher)")
            self.launch = (kernel, fn, grid, args, kwargs)
        return launch

    def wrapper_launch(self, wrapper):
        fn = getattr(wrapper, "fn", None)
        name = getattr(fn, "__name__", None) or getattr(
            getattr(fn, "fn", None), "__name__", "?")
        raise TraceError(self.name, "launch",
                         f"the kernel {name!r} is wrapped by "
                         f"{type(wrapper).__name__} (@triton.autotune / "
                         f"@triton.heuristics): trace the @triton.jit "
                         f"function under it at one configuration")

    # ---- body recording --------------------------------------------------
    def _record(self, raw: _Raw) -> int:
        if self.phase == "B":
            self.raw_b.append(raw)
            return -1
        self.raw.append(raw)
        return len(self.raw) - 1

    def _count(self, shape) -> None:
        if self.phase != "B":
            self.body.elementwise_elems += float(math.prod(shape) or 1)

    def use(self, x):
        """Consume a value: an accumulator read inside the loop records its
        scratch; returns the scratch index the value carries, if any."""
        if not isinstance(x, Tile) or self.phase == "B":
            return getattr(x, "acc", None)
        if x.acc is None and x.init and self.phase == "A":
            x.acc = len(self.scratch)
            self.scratch.append(TracedScratch(
                x.shape, _dtype_bytes(x.dtype)))
            self._record(_Raw("scratch", x.acc, None, True, False, self.phase))
        if x.acc is not None:
            self._record(_Raw("scratch", x.acc, None, False, False,
                              self.phase))
        return x.acc

    def tile_op(self, a, b, count: bool):
        shape = _broadcast(_shape_of(a), _shape_of(b))
        accs = [self.use(v) for v in (a, b)]
        if count:
            self._count(shape)
        acc = next((s for s in accs if s is not None), None) \
            if self.phase in ("A", "B") else None
        first = a if isinstance(a, Tile) else b
        dtype = getattr(first, "dtype", None) or _standin().float32
        return Tile(shape, dtype, acc=acc)

    def advance(self, ptr: Pointer, off, op: str) -> Pointer:
        p = ptr.param
        if isinstance(off, Tile):
            raise TraceError(self.name, f"argument {p.name!r}",
                             "offset by a loaded value (data-dependent "
                             "addressing is not an affine address "
                             "expression)")
        if isinstance(off, Poison):
            raise TraceError(self.name, f"argument {p.name!r}",
                             f"non-affine offset: {off.reason}")
        idx = _as_index(off)
        if idx is None:
            raise TraceError(self.name, f"argument {p.name!r}",
                             f"offset by {off!r}, which is not an integer "
                             f"index (non-affine)")
        new = _binary(op, ptr.offset, idx)
        if isinstance(new, Poison):
            raise TraceError(self.name, f"argument {p.name!r}",
                             f"non-affine offset: {new.reason}")
        return Pointer(p, new, ptr.loop_born or self.phase in ("A", "B"))

    def _pointer(self, ptr, what: str) -> Pointer:
        if not isinstance(ptr, Pointer):
            raise TraceError(self.name, "kernel body",
                             f"tl.{what} of {ptr!r}, which is not a pointer "
                             f"argument plus an offset")
        if ptr.loop_born and self.phase == "after":
            raise TraceError(self.name, f"argument {ptr.param.name!r}",
                             f"tl.{what} after the loop through a pointer the "
                             f"loop advanced (not traceable: index the loop "
                             f"variable instead)")
        return ptr

    # ---- the tl surface --------------------------------------------------
    def program_id(self, axis):
        axis = int(axis)
        if not 0 <= axis < len(self.grid):
            raise TraceError(self.name, "kernel body",
                             f"tl.program_id({axis}) of a grid of "
                             f"{len(self.grid)} dimensions")
        return Index((), grid_sym(axis))

    def num_programs(self, axis):
        return self.grid[int(axis)]

    def arange(self, start, end):
        start, end = int(start), int(end)
        n = end - start
        if n <= 0 or n & (n - 1):
            raise TraceError(self.name, "kernel body",
                             f"tl.arange({start}, {end}): its length must be "
                             f"a power of two (Triton's rule)")
        self.lanes += 1
        return Index((n,), start, ((self.lanes, n, 0, 1),))

    def load(self, ptr, mask=None, other=None):
        ptr = self._pointer(ptr, "load")
        shape = _broadcast(ptr.shape, _shape_of(mask), _shape_of(other))
        for v in (mask, other):
            self.use(v)
        raw = self._record(_Raw("op", ptr.param, ptr.offset, False,
                                mask is not None or other is not None,
                                self.phase))
        return Tile(shape, _standin().dtype_of(ptr.param.dtype), access=raw)

    def store(self, ptr, value, mask=None):
        ptr = self._pointer(ptr, "store")
        self.use(value)
        self._record(_Raw("op", ptr.param, ptr.offset, True,
                          mask is not None, self.phase))

    def dot(self, a, b, acc=None, out_dtype=None):
        for side, v in (("lhs", a), ("rhs", b)):
            if not isinstance(v, Tile):
                raise TraceError(self.name, "tl.dot",
                                 f"{side} is not a traced tensor: {v!r}")
        if len(a.shape) != 2 or len(b.shape) != 2 or a.shape[1] != b.shape[0]:
            raise TraceError(self.name, "tl.dot",
                             f"unsupported shapes {a.shape} @ {b.shape}")
        self.use(a)
        self.use(b)
        carried = self.use(acc) if acc is not None else None
        m, k = a.shape
        n = b.shape[1]
        if self.phase != "B":
            self.body.matmuls.append(BodyMatmul(m, k, n, a.access, b.access))
        dtype = out_dtype or _standin().float32
        return Tile((m, n), dtype,
                    acc=carried if self.phase in ("A", "B") else None)

    def full(self, shape, dtype):
        shape = tuple(int(s) for s in (shape if isinstance(shape, (tuple, list))
                                       else (shape,)))
        return Tile(shape, dtype, init=self.phase is None)

    def where(self, cond, x, y):
        vals = (cond, x, y)
        if any(isinstance(v, Tile) for v in vals):
            shape = _broadcast(*(_shape_of(v) for v in vals))
            for v in vals:
                self.use(v)
            self._count(shape)
            first = next(v for v in (x, y, cond) if isinstance(v, Tile))
            return Tile(shape, first.dtype)
        shape = _broadcast(*(_shape_of(v) for v in vals))
        return Poison(shape, "tl.where of indices is not an affine address")

    def minmax(self, which: str, a, b):
        if isinstance(a, Tile) or isinstance(b, Tile) or \
                isinstance(a, (float, np.floating)) or \
                isinstance(b, (float, np.floating)):
            return self.tile_op(a, b, count=True)
        ia, ib = _as_index(a), _as_index(b)
        if ia is None or ib is None:
            return Poison(_broadcast(_shape_of(a), _shape_of(b)),
                          f"tl.{which} of non-indices")
        if ib.lanes or not ib.base.is_const:
            ia, ib = ib, ia
        if ia.lanes or not ib._lane_free_const():
            return Poison(_broadcast(ia.shape, ib.shape),
                          f"tl.{which} of {ia!r} and {ib!r} is not affine")
        k = ib.base.const
        base = ia.base.clamp_lo(k) if which == "maximum" else ia.base.clamp_hi(k)
        return Index(_broadcast(ia.shape, ib.shape), base)

    def unary(self, name: str, x):
        if isinstance(x, Tile):
            return self.tile_op(x, 0.0, count=True)
        if isinstance(x, (Index, Poison, Mask)):
            shape = x.shape
            self._count(shape)
            return Tile(shape, _standin().float32)
        return x

    def reduce(self, x, axis, keep_dims):
        if not isinstance(x, Tile):
            x = Tile(_shape_of(x), _standin().float32)
        self.use(x)
        self._count(x.shape)
        nd = len(x.shape)
        if axis is None:
            shape = (1,) * nd if keep_dims else ()
        else:
            axes = {int(a) % nd for a in
                    (axis if isinstance(axis, (tuple, list)) else (axis,))}
            shape = tuple(1 if i in axes else s for i, s in enumerate(x.shape)
                          if keep_dims or i not in axes)
        return Tile(shape, x.dtype)

    def trans(self, x):
        if isinstance(x, Tile):
            return Tile(tuple(reversed(x.shape)), x.dtype, x.access, x.acc,
                        x.init)
        if isinstance(x, Index):
            n = len(x.shape)
            return Index(tuple(reversed(x.shape)), x.base,
                         tuple((u, e, n - 1 - a, c) for u, e, a, c in x.lanes))
        raise TraceError(self.name, "tl.trans", f"of {x!r}")

    def loop(self, args, what: str):
        """``range`` / ``tl.range`` / ``tl.static_range`` in the body."""
        vals = []
        for v in args:
            try:
                vals.append(int(v))
            except (TypeError, NonAffineError) as e:
                raise TraceError(self.name, "loop",
                                 f"{what}({', '.join(map(repr, args))}): a "
                                 f"bound is not a compile-time integer "
                                 f"({e})") from e
        lo, hi, step = (0, vals[0], 1) if len(vals) == 1 else \
            (vals[0], vals[1], vals[2] if len(vals) > 2 else 1)
        if self.phase in ("A", "B"):
            raise TraceError(self.name, "loop",
                             f"{what} inside the loop: nested loops are not "
                             f"traceable (one loop a kernel, which becomes "
                             f"the trailing grid dimension)")
        if self.loop_dim is not None:
            raise TraceError(self.name, "loop",
                             f"a second {what} after the first: one loop a "
                             f"kernel is traceable (it becomes the trailing "
                             f"grid dimension)")
        if step <= 0:
            raise TraceError(self.name, "loop",
                             f"{what} with step {step}: not traceable")
        n = max(0, -(-(hi - lo) // step))
        if n == 0:
            return iter(())
        sym = grid_sym(len(self.grid))
        self.extent[sym] = n
        self.loop_dim = (sym, n)
        return self._iterate(Index((), affine(sym) * step + lo))

    def _iterate(self, var):
        first_lane = self.lanes
        self.phase = "A"
        yield var
        self.phase = "B"
        self.lanes = first_lane                 # its aranges are the same lanes
        yield var
        self.phase = "after"
        self._reconcile()

    def _reconcile(self):
        """Give each access the loop's second pass moved by a constant the
        loop symbol times that step."""
        sym, _n = self.loop_dim
        first = [r for r in self.raw if r.phase == "A" and r.kind == "op"]
        second = [r for r in self.raw_b if r.kind == "op"]
        if len(first) != len(second) or any(
                (a.ref, a.store) != (b.ref, b.store)
                for a, b in zip(first, second)):
            raise TraceError(self.name, "loop",
                             "two iterations of the loop made different "
                             "loads and stores")
        for a, b in zip(first, second):
            d = _binary("sub", b.offset, a.offset)
            if isinstance(d, Poison) or d.lanes or not d.base.is_const:
                raise TraceError(self.name, f"argument {a.ref.name!r}",
                                 f"advanced by {d!r} an iteration of the "
                                 f"loop: not a constant step (non-affine)")
            if d.base.const:
                a.offset = _binary("add", a.offset,
                                   Index((), affine(sym) * d.base.const))

    # ---- windows ---------------------------------------------------------
    def split(self, p: _Param, offset: Index, masked: bool):
        """Per-dimension origins and extents of one window of ``p``."""
        where = f"argument {p.name!r}"
        nd = len(p.shape)
        order = sorted(range(nd),
                       key=lambda d: (-p.strides[d], p.shape[d] == 1, d))
        extents = [1] * nd
        for _u, n, _axis, c in offset.lanes:
            if n == 1:                      # a lane of one element: a no-op
                continue
            dims = [d for d in order if p.strides[d] == c]
            if not dims:
                raise TraceError(self.name, where,
                                 f"a lane of {n} elements {c} apart, which is "
                                 f"no stride of the argument {p.strides}: the "
                                 f"window is not rectangular (non-affine)")
            d = dims[0]
            if extents[d] != 1:
                raise TraceError(self.name, where,
                                 f"two lanes along its dimension {d}: the "
                                 f"window is not rectangular (non-affine)")
            if d != order[0] and n > p.shape[d] and not masked:
                raise TraceError(self.name, where,
                                 f"a window of {n} along its dimension {d} of "
                                 f"{p.shape[d]}: the offset does not split "
                                 f"into its dimensions")
            extents[d] = n
        origins = [affine(0)] * nd
        rem = offset.base.const
        for atom, a in offset.base.terms:
            lo, hi = _atom_range(self, atom)
            if lo == hi:                # a grid dimension of extent 1: 0
                rem += a * lo
                continue
            for d, q in self._split_term(p, order, a, where).items():
                origins[d] = origins[d] + AffineExpr(((atom, q),))
        for k in range(nd - 1, -1, -1):        # innermost first
            d, s = order[k], p.strides[order[k]]
            if k == 0 or not s or rem % s or p.strides[order[k - 1]] % s:
                q, rem = (rem // s, rem % s) if s else (0, rem)
            else:
                q = self._const_digit(origins[d], extents[d], p.shape[d],
                                      rem // s, p.strides[order[k - 1]] // s)
                rem -= q * s
            origins[d] = origins[d] + q
        if rem:
            raise TraceError(self.name, where,
                             f"constant offset {offset.base.const} does not "
                             f"split by the strides {p.strides}")
        for d in order[1:]:
            sym_part = origins[d] - origins[d].const
            lo, hi = _expr_range(sym_part)
            if hi - lo > p.shape[d] - 1:
                raise TraceError(self.name, where,
                                 f"the window's origin along its dimension "
                                 f"{d} ({origins[d]!r}) runs past its "
                                 f"{p.shape[d]} elements: the offset does not "
                                 f"split into its dimensions")
        return tuple(origins), tuple(extents)

    @staticmethod
    def _const_digit(sym_part, extent, size, q0, period) -> int:
        """The constant step along one dimension: one of ``q0 + k * period``
        (the values the flat offset allows), the nearest to 0 among those
        that keep the window inside the dimension over the grid, else the
        nearest to 0 (a signed halo tap: ``-X - 1`` is (-1, -1))."""
        lo, hi = _expr_range(sym_part)
        q0 %= period
        first, last = -lo, size - extent - hi   # the q that keep it inside
        inside = [q for q in (q0 + period * ((first - q0) // period + j)
                              for j in (0, 1)) if first <= q <= last]
        if inside:
            return min(inside, key=abs)
        return min((q0, q0 - period), key=abs)

    def _split_term(self, p, order, a, where) -> dict:
        """The coefficient ``a`` of one symbol as per-dimension steps, digit
        by digit from the outermost dimension (an in-bounds window's steps
        along inner dimensions are smaller than those dimensions)."""
        sign, m, out = (-1 if a < 0 else 1), abs(a), {}
        for d in order:
            s = p.strides[d]
            if s:
                q, m = divmod(m, s)
                if q:
                    out[d] = sign * q
        if m:
            raise TraceError(self.name, where,
                             f"coefficient {a} does not split by the strides "
                             f"{p.strides}")
        return out

    # ---- helpers for jit functions ---------------------------------------
    def call_body(self, fn, args, kwargs):
        traced = self.funcs.get(id(fn))
        if traced is None:
            traced = types.FunctionType(fn.__code__, _rewrite_globals(
                self, fn.__globals__), fn.__name__, fn.__defaults__,
                fn.__closure__)
            traced.__kwdefaults__ = fn.__kwdefaults__
            self.funcs[id(fn)] = traced
        return traced(*args, **kwargs)


def _is_triton_kind(v, *names) -> bool:
    t = type(v)
    return t.__name__ in names and t.__module__.startswith(
        ("triton.", "repro_torch.frontend.tl"))


class _Extra:
    """``triton.language.extra`` (libdevice and friends): not traceable."""

    def __init__(self, what: str):
        self._what = what

    def _refuse(self, *_a, **_k):
        raise TraceError(_ctx().name, "kernel body",
                         f"{self._what} is from triton.language.extra, which "
                         f"the tracer does not follow")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return _Extra(f"{self._what}.{name}")

    __call__ = _refuse


def _rewrite_globals(ctx, g: dict) -> dict:
    tl = _standin()
    real_tl = _real_module("triton.language")
    out = dict(g)
    for k, v in g.items():
        if v is tl or v is real_tl or (k == "tl" and isinstance(
                v, types.ModuleType)):
            out[k] = tl
        elif _is_triton_kind(v, "JITFunction"):
            out[k] = (lambda jit: lambda *a, **kw: ctx.call_body(
                jit.fn, a, kw))(v)
        elif _is_triton_kind(v, "Autotuner", "Heuristics"):
            out[k] = (lambda w: lambda *a, **kw: ctx.wrapper_launch(w))(v)
        else:
            mod = getattr(v, "__name__", "") if isinstance(
                v, types.ModuleType) else getattr(v, "__module__", "") or ""
            if mod.startswith("triton.language.extra"):
                out[k] = _Extra(f"{k} ({mod})")
            elif mod.startswith("triton.language") and callable(v) and \
                    not isinstance(v, type) and hasattr(v, "__name__"):
                out[k] = getattr(tl, v.__name__)
    out["range"] = tl.range
    return out


def _real_module(name: str):
    import sys

    return sys.modules.get(name)


def _real_triton_patches(ctx: _Trace) -> list:
    """``(class, attribute, original, replacement)`` for an installed
    Triton; none without it."""
    try:
        from triton.runtime import jit as rt_jit
    except Exception:  # noqa: BLE001 - no Triton here: the stand-in only
        return []
    jit_cls, iface = rt_jit.JITFunction, rt_jit.KernelInterface
    missing = object()

    def jit_getitem(self, grid):
        return ctx.launcher(self, self.fn, grid)

    def wrapper_getitem(self, grid):
        ctx.wrapper_launch(self)

    return [(jit_cls, "__getitem__", jit_cls.__dict__.get("__getitem__", missing),
             jit_getitem, missing),
            (iface, "__getitem__", iface.__dict__.get("__getitem__", missing),
             wrapper_getitem, missing)]


class _patched:
    """Context manager installing/removing the tracing patch table."""

    def __init__(self, ctx: _Trace):
        self.ctx = ctx
        self.patches = []

    def __enter__(self):
        global _CTX
        if _CTX is not None:
            raise TraceError(self.ctx.name, "trace",
                             "nested kernel traces are not supported")
        self.patches = _real_triton_patches(self.ctx)
        for cls, attr, _orig, new, _missing in self.patches:
            setattr(cls, attr, new)
        _CTX = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        global _CTX
        _CTX = None
        for cls, attr, orig, _new, missing in reversed(self.patches):
            if orig is missing:
                delattr(cls, attr)
            else:
                setattr(cls, attr, orig)
        return False


# --------------------------------------------------------------------------
# trace_kernel and its post-processing
# --------------------------------------------------------------------------
def _meta_tensors(args) -> tuple:
    import torch

    out = []
    for a in args:
        dt = a.dtype
        if type(dt).__module__ != "torch":
            npdt = np.dtype(dt)
            dt = torch.bfloat16 if npdt.name == "bfloat16" else \
                torch.from_numpy(np.empty(0, npdt)).dtype
        out.append(torch.empty(a.shape, dtype=dt, device="meta"))
    return tuple(out)


def _validate_grid(name, grid, meta):
    if callable(grid):
        grid = grid(meta)
    if not isinstance(grid, (tuple, list)):
        grid = (grid,)
    out = []
    for g in grid:
        if not _is_int(g):
            raise TraceError(
                name, "grid",
                f"data-dependent grid entry {g!r} — the estimator needs a "
                f"static launch structure (hoist the size to a Python int)")
        out.append(int(g))
    if not 1 <= len(out) <= 3:
        raise TraceError(name, "grid", f"a grid of {len(out)} dimensions")
    return tuple(out)


def _is_tensor(v) -> bool:
    return type(v).__module__.startswith("torch") and hasattr(v, "stride") \
        and hasattr(v, "dtype") and hasattr(v, "shape")


def _bind(ctx: _Trace, fn, args, kwargs) -> tuple:
    sig = inspect.signature(fn)
    takes_kw = any(p.kind is p.VAR_KEYWORD for p in sig.parameters.values())
    kwargs = {k: v for k, v in kwargs.items()
              if takes_kw or k in sig.parameters}
    try:
        bound = sig.bind(*args, **kwargs)
    except TypeError as e:
        raise TraceError(ctx.name, "launch", f"arguments do not bind: {e}") \
            from e
    bound.apply_defaults()
    by_id = {}
    for i, m in enumerate(ctx.metas):
        by_id[id(m)] = i
    vals = {}
    for pname, v in bound.arguments.items():
        if _is_tensor(v):
            root = v._base if getattr(v, "_base", None) is not None else v
            pos = by_id.get(id(root))
            name = ctx.args[pos].name if pos is not None else pname
            param = _Param(len(ctx.params), name, pos, v)
            ctx.params.append(param)
            vals[pname] = Pointer(param, Index((), 0))
        else:
            vals[pname] = v
    return bound, vals


def trace_kernel(call_fn, args, *, name: str = "kernel",
                 operand_names=None, out_names=None,
                 trace_body: bool = False,
                 require_body: bool = False) -> TracedKernel:
    """Trace one Triton launcher into a :class:`TracedKernel`.

    ``call_fn`` is the launcher (the closure a user writes around
    ``kernel[grid](...)``); ``args`` its positional arguments as
    :func:`arg` placeholders, handed to it as ``meta`` tensors.
    ``operand_names`` optionally names every operand (inputs then
    outputs); by default an input is named by its placeholder and an output
    by its placeholder, else ``out`` / ``out{i}``, unless ``out_names`` says
    otherwise.  The kernel body always runs (its windows are the operands);
    with ``trace_body=True`` its digest (accesses, matmuls, elementwise
    counts) is kept, and a body failure is recorded (``traced.body.error``)
    unless ``require_body=True``.
    """
    args = tuple(args)
    ctx = _Trace(name, args)
    ctx.metas = _meta_tensors(args)
    with _patched(ctx):
        try:
            call_fn(*ctx.metas)
        except TraceError:
            raise
        except NonAffineError as e:
            raise TraceError(name, "launcher", str(e)) from e
        if ctx.launch is None:
            raise TraceError(name, "launcher",
                             "the launcher never launched a Triton kernel")
        _kernel, fn, grid, largs, lkwargs = ctx.launch
        bound, vals = _bind(ctx, fn, largs, lkwargs)
        ctx.grid = _validate_grid(name, grid, dict(bound.arguments))
        for d, g in enumerate(ctx.grid):
            ctx.extent[grid_sym(d)] = g
        error = _run_body(ctx, fn, vals)
    if error is not None and (require_body or not trace_body):
        raise error
    traced = _postprocess(ctx, name, operand_names, out_names, error)
    if not trace_body:
        traced.body = TracedBody()
    return traced


def _run_body(ctx: _Trace, fn, vals) -> TraceError | None:
    """Run the body, then split every access it made into its window; the
    first failure is the body's error (the windows split before it stay)."""
    err = None
    try:
        ctx.call_body(fn, (), vals)
        if ctx.phase in ("A", "B"):
            raise TraceError(ctx.name, "loop", "the body left its loop early")
    except TraceError as e:
        err = e
    except NonAffineError as e:
        err = TraceError(ctx.name, "kernel body", str(e))
    except (TypeError, AttributeError, ValueError) as e:
        err = TraceError(ctx.name, "kernel body",
                         f"not traceable: {type(e).__name__}: {e}")
    for i, raw in enumerate(ctx.raw):
        if raw.kind != "op" or (err is not None and raw.phase in ("A", "B")):
            continue
        try:
            origins, extents = ctx.split(raw.ref, raw.offset, raw.masked)
        except TraceError as e:
            err = err or e
            continue
        raw.ref.windows.append((i, origins, extents))
    ctx.body.ok = err is None
    ctx.body.error = None if err is None else str(err)
    return err


def _block(ctx: _Trace, p: _Param):
    """The bounding box of ``p``'s windows in one step: block shape, block
    index per dimension, grid dependences, and each window's offsets."""
    nd = len(p.shape)
    if not p.windows:                       # the body stopped before it
        return (p.shape, (affine(0),) * nd, (), {})
    blocks, idx, deps = [], [], set()
    offsets = {i: [None] * nd for i, _o, _e in p.windows}
    for d in range(nd):
        base0 = p.windows[0][1][d]
        consts = []
        for _i, origins, _e in p.windows:
            delta = origins[d] - base0
            if not delta.is_const:
                raise TraceError(ctx.name, f"argument {p.name!r}",
                                 f"windows in one step start at {base0!r} and "
                                 f"{origins[d]!r} along dimension {d}: no "
                                 f"block of one shape covers them")
            consts.append(delta.const)
        lo = min(consts)
        b = max(c + e[d] for c, (_i, _o, e) in zip(consts, p.windows)) - lo
        base = base0 + lo
        exact = base.const % b == 0 and all(c % b == 0 for _a, c in base.terms)
        ix = base // b if exact else affine(0)
        for i, origins, _e in p.windows:
            off = origins[d] - ix * b
            offsets[i][d] = off.const if off.is_const else off
        deps |= {int(s.name[1:]) for s in base.free_syms()}
        blocks.append(b)
        idx.append(ix)
    return tuple(blocks), tuple(idx), tuple(sorted(deps)), offsets


def _postprocess(ctx: _Trace, name: str, operand_names, out_names,
                 error) -> TracedKernel:
    # after a body error, an argument the body never reached is taken whole
    params = [p for p in ctx.params if p.windows or (
        error is not None and p.placeholder is not None)]
    outs = {id(p) for p in params
            if any(ctx.raw[i].store for i, _o, _e in p.windows)}
    inputs = [p for p in params if id(p) not in outs]
    outputs = [p for p in params if id(p) in outs]
    uses = {}
    for p in inputs:
        if p.placeholder is None:
            raise TraceError(
                name, f"argument {p.name!r}",
                "an input is not one of the traced placeholder arguments "
                "(launchers must pass their inputs through unchanged)")
        uses[p.placeholder] = uses.get(p.placeholder, 0) + 1
    names, seen = [], {}
    for p in inputs:
        base = ctx.args[p.placeholder].name
        seen[p.placeholder] = seen.get(p.placeholder, -1) + 1
        names.append(base if uses[p.placeholder] == 1
                     else f"{base}{seen[p.placeholder]}")
    for j, p in enumerate(outputs):
        if out_names is not None:
            names.append(list(out_names)[j])
        elif p.placeholder is not None:
            names.append(ctx.args[p.placeholder].name)
        else:
            names.append("out" if len(outputs) == 1 else f"out{j}")
    if operand_names is not None:
        if len(operand_names) != len(names):
            raise TraceError(name, "operand_names",
                             f"{len(operand_names)} names for {len(names)} "
                             f"operands")
        names = list(operand_names)

    operands, index_of, window_offsets = [], {}, {}
    for k, p in enumerate(inputs + outputs):
        blocks, idx, deps, offs = _block(ctx, p)
        out = k >= len(inputs)
        pos = p.placeholder if p.placeholder is not None else \
            len(ctx.args) + k - len(inputs)
        operands.append(TracedOperand(
            name=names[k], block_shape=blocks, elem_bytes=p.elem_bytes,
            index_exprs=idx, grid_deps=deps, is_output=out,
            arg_name=names[k] if out else ctx.args[p.placeholder].name,
            arg_shape=p.shape, arg_pos=pos))
        index_of[id(p)] = k
        window_offsets.update(offs)
        for i, _o, extents in p.windows:
            window_offsets[i] = (window_offsets[i], extents)

    body = ctx.body
    made, seen_keys = {}, set()
    for i, raw in enumerate(ctx.raw):
        if raw.kind == "op":
            if i not in window_offsets:
                continue
            offsets, extents = window_offsets[i]
            acc = BodyAccess("op", index_of[id(raw.ref)], tuple(offsets),
                             tuple(extents), is_store=raw.store)
        else:
            shape = ctx.scratch[raw.ref].shape
            acc = BodyAccess("scratch", raw.ref, (0,) * len(shape), shape,
                             is_store=raw.store)
        made[i] = acc
        key = (acc.ref_kind, acc.ref_index,
               tuple(_off_key(o) for o in acc.offsets), acc.extents,
               acc.is_store)
        if key not in seen_keys:
            seen_keys.add(key)
            if raw.masked:
                body.masked.append(len(body.accesses))
            body.accesses.append(acc)
    for mm in body.matmuls:
        mm.lhs = made.get(mm.lhs) if isinstance(mm.lhs, int) else mm.lhs
        mm.rhs = made.get(mm.rhs) if isinstance(mm.rhs, int) else mm.rhs
    grid = ctx.grid + ((ctx.loop_dim[1],) if ctx.loop_dim else ())
    return TracedKernel(name=name, grid=grid, operands=tuple(operands),
                        scratch=tuple(ctx.scratch), body=body)


def _off_key(o):
    return o._key() if isinstance(o, AffineExpr) else int(o)


__all__ = [
    "BodyAccess", "BodyMatmul", "Placeholder", "TraceError", "TracedBody",
    "TracedKernel", "TracedOperand", "TracedScratch", "arg", "grid_sym",
    "trace_kernel",
]
