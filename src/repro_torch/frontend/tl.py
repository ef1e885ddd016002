"""A stand-in for ``triton`` and ``triton.language`` that only traces.

A kernel module imports Triton where it is installed and this module where
it is not:

    try:
        import triton
        import triton.language as tl
    except ImportError:
        from repro_torch.frontend import tl
        triton = tl

so ``@triton.jit``, ``tl.constexpr`` and the dtypes resolve when the module
is imported on a machine without Triton (the tests' CPU), and
``repro_torch.frontend.trace_kernel`` can trace the kernel there.  With
Triton installed the tracer swaps every binding of ``triton.language`` in
a kernel's globals for this module, so the same functions below act on the
trace in both cases.

The names are those a traced kernel uses: ``constexpr``, ``program_id``,
``num_programs``, ``arange``, ``load``, ``store``, ``dot``, ``zeros``,
``full``, ``where``, ``maximum``, ``minimum``, ``exp``, ``exp2``, ``log``,
``sqrt``, ``abs``, ``sum``, ``max``, ``min``, ``cdiv``, ``static_range``,
``range``, ``trans``, the dtypes, and ``jit``, ``autotune``,
``heuristics`` and ``Config``.  Outside
a trace every one of them raises an error that says so (``cdiv`` is plain
arithmetic, as Triton's host-side ``triton.cdiv``).  Any other ``tl`` name
is a ``TraceError`` that names it, as are ``autotune`` / ``heuristics``
wrappers and ``tl.extra``.
"""
from __future__ import annotations

import functools

from . import trace as _trace


def _active(what: str):
    ctx = _trace._CTX
    if ctx is None:
        raise RuntimeError(
            f"tl.{what} called outside a trace: this stand-in for "
            f"triton.language only traces kernels (repro_torch.frontend."
            f"trace_kernel); running one needs Triton and a card")
    return ctx


# ---- dtypes -----------------------------------------------------------------
class dtype:
    """A Triton element type: its name (Triton's) and size."""

    def __init__(self, name: str, itemsize: int):
        self.name = name
        self.itemsize = itemsize
        self.primitive_bitwidth = 8 * itemsize

    def __repr__(self):
        return self.name


int1 = dtype("int1", 1)
int8, int16, int32, int64 = (dtype(f"int{b}", b // 8) for b in (8, 16, 32, 64))
uint8 = dtype("uint8", 1)
float16, bfloat16 = dtype("fp16", 2), dtype("bf16", 2)
float32, float64 = dtype("fp32", 4), dtype("fp64", 8)
_BY_TORCH = {"float16": float16, "bfloat16": bfloat16, "float32": float32,
             "float64": float64, "int8": int8, "int16": int16,
             "int32": int32, "int64": int64, "uint8": uint8, "bool": int1}


def dtype_of(torch_dtype) -> dtype:
    """The element type of a tensor of ``torch_dtype``."""
    return _BY_TORCH.get(str(torch_dtype).replace("torch.", ""), float32)


class constexpr:
    """``tl.constexpr``: an annotation, or a value wrapper that traces as
    its value."""

    def __new__(cls, value=None):
        return value


# ---- the launch -----------------------------------------------------------
class JITFunction:
    """``@jit``: a kernel whose launch ``kernel[grid](...)`` a trace
    captures."""

    def __init__(self, fn):
        self.fn = fn
        functools.update_wrapper(self, fn)

    def __getitem__(self, grid):
        ctx = _trace._CTX
        if ctx is None:
            raise RuntimeError(
                f"{self.fn.__name__}[grid](...) outside a trace: Triton is not "
                f"installed, so this kernel can only be traced "
                f"(repro_torch.frontend.trace_kernel)")
        return ctx.launcher(self, self.fn, grid)

    def __call__(self, *_a, **_k):
        raise RuntimeError(f"@jit function {self.fn.__name__} called outside "
                           f"a kernel: launch it as kernel[grid](...)")


def jit(fn=None, **_options):
    if fn is None:
        return lambda f: JITFunction(f)
    return JITFunction(fn)


class _Wrapper:
    """An ``@autotune`` / ``@heuristics`` wrapper: not traceable."""

    def __init__(self, kind: str, fn):
        self.kind, self.fn = kind, fn

    def __getitem__(self, grid):
        ctx = _trace._CTX
        if ctx is None:
            raise RuntimeError(f"@{self.kind} kernel launched outside a trace: "
                               f"Triton is not installed")
        ctx.wrapper_launch(self)


class Autotuner(_Wrapper):
    pass


class Heuristics(_Wrapper):
    pass


def autotune(configs=(), key=(), **_kw):
    return lambda fn: Autotuner("autotune", fn)


def heuristics(values=None):
    return lambda fn: Heuristics("heuristics", fn)


class Config:
    """``triton.Config``: kept, never read."""

    def __init__(self, kwargs=None, num_warps=4, num_stages=2, **kw):
        self.kwargs, self.num_warps, self.num_stages = kwargs or {}, \
            num_warps, num_stages


def cdiv(a, b):
    """Ceiling division, on the host and in a traced body."""
    return (a + b - 1) // b


# ---- the body ---------------------------------------------------------------
def program_id(axis):
    return _active("program_id").program_id(axis)


def num_programs(axis):
    return _active("num_programs").num_programs(axis)


def arange(start, end):
    return _active("arange").arange(start, end)


def load(pointer, mask=None, other=None, **_hints):
    return _active("load").load(pointer, mask, other)


def store(pointer, value, mask=None, **_hints):
    return _active("store").store(pointer, value, mask)


def dot(input, other, acc=None, input_precision=None, allow_tf32=None,
        max_num_imprecise_acc=None, out_dtype=None):
    return _active("dot").dot(input, other, acc, out_dtype)


def zeros(shape, dtype):
    return _active("zeros").full(shape, dtype)


def full(shape, value, dtype):
    return _active("full").full(shape, dtype)


def where(condition, x, y):
    return _active("where").where(condition, x, y)


def maximum(x, y, **_kw):
    return _active("maximum").minmax("maximum", x, y)


def minimum(x, y, **_kw):
    return _active("minimum").minmax("minimum", x, y)


def _unary(name):
    def fn(x, **_kw):
        return _active(name).unary(name, x)
    fn.__name__ = name
    return fn


exp, exp2, log, sqrt, abs = (_unary(n) for n in
                             ("exp", "exp2", "log", "sqrt", "abs"))


def sum(input, axis=None, keep_dims=False, **_kw):
    return _active("sum").reduce(input, axis, keep_dims)


def max(input, axis=None, return_indices=False, keep_dims=False, **_kw):
    return _active("max").reduce(input, axis, keep_dims)


def min(input, axis=None, return_indices=False, keep_dims=False, **_kw):
    return _active("min").reduce(input, axis, keep_dims)


def trans(input, *_dims):
    return _active("trans").trans(input)


def range(*args, **_kw):
    return _active("range").loop(args, "range")


def static_range(*args, **_kw):
    return _active("static_range").loop(args, "tl.static_range")


class _Extra:
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return _trace._Extra(f"tl.extra.{name}")


extra = _Extra()


def __getattr__(name: str):
    """Any other ``tl`` name: a ``TraceError`` naming it once it is used."""
    if name.startswith("__"):
        raise AttributeError(name)

    def unsupported(*_a, **_k):
        ctx = _active(name)
        raise _trace.TraceError(ctx.name, "kernel body",
                                f"tl.{name} is not supported by the tracer")
    unsupported.__name__ = name
    return unsupported
