"""Counted cost of a torch program: the port's counterpart of XLA's
``compiled.cost_analysis()`` and ``compiled.memory_analysis()``.

``count_cost(fn, *args)`` runs ``fn`` once under a ``TorchDispatchMode``
and counts every aten op it reaches, the backward's and a remat
recompute's too (``torch.utils.checkpoint`` runs its recompute under the
same mode).  On the ``meta`` device nothing is allocated and nothing needs
a card: meta tensors are the counterpart of the reference's
``ShapeDtypeStruct`` stand-ins.  The same call on the card counts the same
program on real tensors.

Operations follow XLA's ``HloCostAnalysis`` convention, so that totals
compare with the reference's ``cost_analysis()``:

* products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions) by
  ``torch.utils.flop_counter``'s registered formulas: ``dot_flops``.  A
  pairwise product without a contracted index inside ``torch.einsum``
  (an outer product, which torch computes as ``mul`` and XLA as a
  ``dot_general``) counts two a result element there too;
* an elementwise arithmetic op one flop a result element; ``exp``,
  ``log``, ``tanh``, ``rsqrt``, ``sigmoid``, ``erf``, ``sin``, ``cos`` and
  the like one transcendental instead (``silu``, ``gelu``, ``softplus``,
  softmax and ``logsumexp`` count the flops and transcendentals of their
  elementwise forms);
* a reduction one flop an input element;
* views, copies, casts, gathers, ``cat``, ``index_put_`` and factories
  none.

``bytes`` is unfused: the inputs and outputs of every op that is not a
view, where XLA's fusion would keep most of them on chip (the reference's
CPU ``cost_analysis()`` reads unfused bytes too).  Memory: ``argument_bytes``
is the storages of the arguments; ``temp_bytes`` the peak of every other
storage live at once (each tracked by a weak reference to its storage, so
tensors that autograd saves count until the backward frees them);
``peak_bytes`` their sum, as ``core.roofline`` takes XLA's.

A step over DTensors (``train.sharding.place`` on a ``DeviceMesh``) is
counted as one rank's program, XLA's per-device ``cost_analysis()`` and
``memory_analysis()`` of the SPMD-partitioned module: the mode lets DTensor
dispatch first (``NotImplemented``, as ``CommDebugMode`` does), so it sees
the local ops on each rank's shards and the ``_c10d_functional``
collectives of DTensor's redistributions, and the arguments' and outputs'
sizes are their local shards'.  DTensor's sharding propagation, which runs
an op once at global shapes on ``FakeTensor``s the first time it meets
those shapes, is counted nowhere, so the counts do not depend on what its
cache has seen.  The process group's rank 0 stands for every device:
where a dim does not divide its mesh dims, its shard is the largest
(``torch.chunk``'s ceil), as XLA pads every shard to that size.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .hlo import TORCH_COLLECTIVES, collective_bytes_of

# aten's names, an in-place op's trailing "_" dropped
TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "rsqrt",
                  "sqrt", "sigmoid", "erf", "erfc", "erfinv", "sin", "cos", "tan", "atan",
                  "atan2", "pow", "logit"}
# (flops, transcendentals) an element of the ops that are not plain arithmetic
COMPOSITE = {
    "silu": (1, 1),          # x * sigmoid(x)
    "gelu": (7, 1),          # the tanh form: 0.5x(1 + tanh(c(x + 0.044715x^3)))
    "softplus": (3, 2),      # logaddexp(x, 0): max, abs, sub, exp, log1p, add
    "_softmax": (4, 1),      # max, sub, exp, sum, div
    "_log_softmax": (4, 1),  # max, sub, exp, sum, log (a row), sub
    "logsumexp": (3, 1),     # max, sub, exp, sum, log (a row), add
}
COMPOSITE_OF_INPUT = {"_softmax", "_log_softmax", "logsumexp"}  # counted on the input
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "norm", "linalg_vector_norm",
              "any", "all", "argmax", "argmin", "var", "var_mean", "std", "cumsum", "cumprod",
              "nansum", "count_nonzero"}
# the one copy that aten tags pointwise: views, casts, gathers, scatters,
# cat and factories carry no pointwise tag, so they count no flops anyway
NO_FLOPS = {"clone"}
# ops that allocate without moving bytes, or a view aten does not mark as one
NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
            "_unsafe_view"}


@dataclass
class Cost:
    """What ``count_cost`` counted: XLA's ``cost_analysis()`` keys as
    attributes (``flops``, ``transcendentals``, ``bytes``), the products
    apart (``dot_flops``), ``memory_analysis()``'s sizes, and the
    collectives as ``core.hlo.collective_bytes`` gives them."""
    flops: float = 0.0
    dot_flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    ops: int = 0
    collectives: dict = field(default_factory=dict)

    def memory(self) -> dict:
        """The reference's ``memory_analysis`` dict (``core.roofline``)."""
        return {"argument_bytes": self.argument_bytes, "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes, "peak_bytes": self.peak_bytes}


def _name(func) -> str:
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


def _tensors(tree, out=None) -> list:
    """The tensors in a nest of tuples, lists and dicts (an op's arguments
    or results; a tree of the caller's)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storages(tree) -> dict:
    """{storage key: bytes} of the tensors in ``tree``.  A DTensor counts
    its local shard by the shard's own bytes: ``distribute_tensor`` may cut
    it as a view of the whole leaf's storage."""
    out = {}
    for t in _tensors(tree):
        local = getattr(t, "_local_tensor", None)
        if local is not None:
            out[local.untyped_storage()._cdata] = _nbytes(local)
        else:
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


class _Einsums(TorchFunctionMode):
    """Marks the aten ops that run inside ``torch.einsum``: there a ``mul``
    is a pairwise product without a contracted index."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is not torch.einsum:
            return func(*args, **(kwargs or {}))
        self.counter.in_einsum += 1
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.counter.in_einsum -= 1


def _propagating(ins: list) -> bool:
    """Whether an op on the tensors ``ins`` runs under DTensor's sharding
    propagation: a fake mode active, or ``FakeTensor`` arguments."""
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
        return True
    return any(isinstance(t, FakeTensor) for t in ins)


class _Counter(TorchDispatchMode):
    def __init__(self, arguments: dict):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self.dtensor = DTensor
        self.cost = Cost(argument_bytes=sum(arguments.values()))
        self.arguments = arguments
        self.in_einsum = 0
        self.coll = []
        self.live = {}          # storage key -> (weak reference, bytes); not the arguments'
        self.upper = 0          # bytes of ``live``, the expired ones not yet taken off
        self.peak = 0

    # memory -------------------------------------------------------------
    def _sweep(self):
        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.upper -= n

    def _track(self, ins: list, outs: list):
        """Registers the storages an op allocated: not its inputs' (a view,
        an in-place op), not the arguments'."""
        used = None
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.arguments:
                continue
            if used is None:
                used = {i.untyped_storage()._cdata for i in ins}
            if key in used:
                continue
            seen = self.live.get(key)
            if seen is not None:
                if not seen[0].expired():
                    continue
                self.upper -= seen[1]     # a new storage where a freed one was
            n = st.nbytes()
            self.live[key] = (StorageWeakRef(st), n)
            self.upper += n
            if self.upper > self.peak:
                # only a sweep tells whether this is a new peak
                self._sweep()
                self.peak = max(self.peak, self.upper)

    # operations ---------------------------------------------------------
    def _count(self, func, args, kwargs, out, ins: list, outs: list):
        c = self.cost
        c.ops += 1
        name = _name(func)
        if func.namespace == "_c10d_functional" and name in TORCH_COLLECTIVES:
            group = [a for a in args if isinstance(a, str)][-1]
            self.coll.append((name, sum(map(_nbytes, ins)), sum(map(_nbytes, outs)),
                              _group_size(group)))
        if not func.is_view and name not in NO_BYTES:
            c.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        n_out = sum(t.numel() for t in outs)
        if func._overloadpacket in flop_registry:
            c.dot_flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        elif self.in_einsum and name == "mul":
            c.dot_flops += 2 * n_out
        elif name in TRANSCENDENTAL:
            c.transcendentals += n_out
        elif name in COMPOSITE:
            f, tr = COMPOSITE[name]
            n = ins[0].numel() if name in COMPOSITE_OF_INPUT else n_out
            c.flops += f * n
            c.transcendentals += tr * n
        elif name in REDUCTIONS:
            c.flops += ins[0].numel() if ins else 0
        elif name in NO_FLOPS or func.is_view:
            pass
        elif torch.Tag.pointwise in func.tags or name.endswith("_backward"):
            # an elementwise op, or a backward kernel (one flop an element)
            c.flops += n_out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, self.dtensor) for t in types):
            return NotImplemented   # DTensor runs first; its local ops come back here
        ins = _tensors(kwargs, _tensors(args))
        if _propagating(ins):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._count(func, args, kwargs, out, ins, outs)
        self._track(ins, outs)
        return out


def _nonzero_at_most():
    """On ``meta`` a data-dependent ``nonzero`` (a placed cache's write,
    ``layers.attention._write_shard``) is taken at its largest, every
    element nonzero: rank 0 writes what the rank holding the slot does."""
    from torch.fx.experimental import _config

    if hasattr(_config, "meta_nonzero_assume_all_nonzero"):
        return _config.patch(meta_nonzero_assume_all_nonzero=True)
    return contextlib.nullcontext()


def count_cost(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its ``Cost``).  The arguments' storages are
    ``argument_bytes``; everything ``fn`` allocates counts toward
    ``temp_bytes`` while it lives, its outputs included.

    Not under ``torch.inference_mode()``: there composite ops (``einsum``)
    reach the mode whole, their products uncounted; ``torch.no_grad()``
    serves a forward."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("count_cost under torch.inference_mode() would miss the products "
                           "of composite ops; use torch.no_grad()")
    arguments = _storages((args, kwargs))
    counter = _Counter(arguments)
    with _nonzero_at_most(), _Einsums(counter), counter:
        out = fn(*args, **kwargs)
    counter._sweep()
    c = counter.cost
    c.flops += c.dot_flops
    c.temp_bytes = counter.peak
    c.peak_bytes = c.argument_bytes + c.temp_bytes
    c.output_bytes = sum(n for k, n in _storages(out).items() if k not in arguments)
    c.collectives = collective_bytes_of(counter.coll)
    return out, c


__all__ = ["Cost", "count_cost"]
