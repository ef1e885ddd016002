"""Lower a :class:`TracedKernel` to the estimator's spec types.

Two targets (DESIGN.md §9):

  * :func:`lower_tpu` — ``tpu_adapt.PallasKernelSpec``.  On TPU the traced
    blocks *are* the address expressions (DESIGN §2): grid dependence of
    each operand's window gives the revisit analysis its fetch counts, a
    traced accumulator gives VMEM residency.  This lowering is purely structural; the
    only non-traceable inputs are the *cost model* numbers (flop counts,
    work units) which are physics the code generator knows and the address
    expressions cannot carry — exactly the paper's split, where the
    generator supplies arithmetic intensity alongside the access artifact.
  * :func:`lower_gpu` — ``core.access.KernelSpec``: thread-level affine
    maps.  The kernel-body accesses (block-relative windows) are composed
    with the operands' block indices into global element coordinates, then
    re-expressed per *domain point* — each input window whose extent
    matches the output store window becomes one ``Access`` with a constant
    offset/dim-map, i.e. the classic stencil/streaming address expression.
    Blocked GEMMs are recognized structurally (one matmul per step whose
    row/column/reduction origins tie lhs/rhs to the output) and lowered to
    the canonical MAC-domain GEMM spec.

Kernels outside either contract raise :class:`~repro_torch.frontend.trace.
TraceError` with the offending operand named, which callers surface as
``report.skipped`` reasons.

A copy of ``repro.frontend.lower`` on the port's ``core.access`` and
``core.tpu_adapt``: it consumes the reference's IR (``trace.TracedKernel``
and its parts), which the port's tracer fills from a Triton launch.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.access import Access, Field, KernelSpec
from repro_torch.core.tpu_adapt import MatmulShape, OperandSpec, PallasKernelSpec

from .affine import AffineExpr, affine
from .trace import BodyAccess, TraceError, TracedKernel


@dataclass(frozen=True)
class CostModel:
    """Arithmetic-cost annotations the address expressions cannot carry.

    ``None`` fields are derived from the traced body digest (elementwise-op
    and matmul counts) when one is available, else fall back to neutral
    defaults.  Generators that need bitwise parity with a hand-tuned model
    pin every field explicitly.
    """

    matmuls_per_step: tuple | None = None     # tuple[MatmulShape, ...]
    vpu_elems_per_step: float | None = None
    vpu_shape: tuple | None = None
    work_per_step: float | None = None
    elem_bytes: int | None = None             # dominant compute dtype
    flops_per_point: float | None = None      # GPU model flops
    work_unit: str = "LUP"


def block_vpu_shape(block_shape: tuple) -> tuple:
    """The vector shape a traced kernel's VPU work is padded by, read off its
    first output's block: the block's dims above 1 (or, where none is, its
    last two), the last two of them."""
    nontrivial = tuple(s for s in block_shape if s > 1) or block_shape[-2:]
    return nontrivial[-2:]


def derive_costs(traced: TracedKernel, base: CostModel | None = None) -> CostModel:
    """Fill unset CostModel fields from the traced body digest."""
    c = base or CostModel()
    body = traced.body
    points = float(traced.points_per_step() or 1)
    matmuls = c.matmuls_per_step
    if matmuls is None:
        matmuls = tuple(MatmulShape(m.m, m.k, m.n) for m in body.matmuls) \
            if body.ok else ()
    vpu = c.vpu_elems_per_step
    if vpu is None:
        vpu = body.elementwise_elems if body.ok else 0.0
    vpu_shape = c.vpu_shape
    if vpu_shape is None:
        vpu_shape = ()
        if traced.outputs:
            vpu_shape = block_vpu_shape(traced.outputs[0].block_shape)
    work = c.work_per_step if c.work_per_step is not None else points
    eb = c.elem_bytes
    if eb is None:
        eb = traced.operands[0].elem_bytes if traced.operands else 4
    flops = c.flops_per_point
    if flops is None:
        flops = (body.elementwise_elems / points) if body.ok else 0.0
    return CostModel(matmuls_per_step=matmuls, vpu_elems_per_step=vpu,
                     vpu_shape=vpu_shape, work_per_step=work, elem_bytes=eb,
                     flops_per_point=flops, work_unit=c.work_unit)


# --------------------------------------------------------------------------
# TPU lowering
# --------------------------------------------------------------------------
def lower_tpu(traced: TracedKernel, costs: CostModel | None = None,
              name: str | None = None) -> PallasKernelSpec:
    """BlockSpecs are the address expressions: emit the Pallas estimator
    spec directly from the trace."""
    c = derive_costs(traced, costs)
    operands = tuple(
        OperandSpec(
            name=op.name,
            block_shape=op.block_shape,
            elem_bytes=op.elem_bytes,
            grid_deps=op.grid_deps,
            is_output=op.is_output,
        )
        for op in traced.operands
    )
    return PallasKernelSpec(
        name=name or traced.name,
        grid=traced.grid,
        operands=operands,
        matmuls_per_step=c.matmuls_per_step,
        vpu_elems_per_step=c.vpu_elems_per_step,
        vpu_shape=c.vpu_shape,
        scratch_bytes=traced.scratch_bytes(),
        work_per_step=c.work_per_step,
        elem_bytes=c.elem_bytes,
    )


# --------------------------------------------------------------------------
# GPU lowering
# --------------------------------------------------------------------------
def _global_exprs(op, access: BodyAccess) -> list:
    """Global element coordinate of an access window's origin, per field
    dim: ``index_map[j] * block_shape[j] + window_offset[j]``."""
    return [
        affine(e) * b + affine(o)
        for e, b, o in zip(op.index_exprs, op.block_shape, access.offsets)
    ]


def _const_delta(a: AffineExpr, b: AffineExpr) -> int | None:
    d = a - b
    return d.const if d.is_const else None


def _reject(traced, where, reason):
    raise TraceError(traced.name, f"gpu lowering: {where}", reason)


def lower_gpu(traced: TracedKernel, costs: CostModel | None = None,
              name: str | None = None, rename: dict | None = None) -> KernelSpec:
    """Thread-level affine maps from the traced body (see module docstring).

    ``rename`` maps traced operand/argument names to estimator field names
    (e.g. ``{"a": "A", "out": "C"}``).
    """
    body = traced.body
    rename = rename or {}
    if not body.ok:
        _reject(traced, "body",
                body.error or "kernel body was not traced "
                "(trace with trace_body=True)")
    if len(traced.outputs) != 1:
        _reject(traced, "outputs",
                f"{len(traced.outputs)} output operands (exactly one "
                f"supported)")
    c = derive_costs(traced, costs)

    gemm = _try_lower_gemm(traced, c, name, rename)
    if gemm is not None:
        return gemm

    if body.scratch_accesses():
        _reject(traced, "scratch",
                "kernel stages data through scratch buffers; its accesses "
                "are not per-point affine address expressions")
    if body.notes:
        _reject(traced, "body", body.notes[0])

    out_idx = next(i for i, op in enumerate(traced.operands) if op.is_output)
    out_op = traced.operands[out_idx]
    stores = [a for a in body.stores("op") if a.ref_index == out_idx]
    if len(stores) != 1:
        _reject(traced, f"operand {out_op.name!r}",
                f"{len(stores)} distinct stores to the output "
                f"(exactly one supported)")
    store = stores[0]
    domain = out_op.arg_shape
    if not 1 <= len(domain) <= 3:
        _reject(traced, f"operand {out_op.name!r}",
                f"output rank {len(domain)} outside the GPU model's "
                f"1-3D domains")
    out_g = _global_exprs(out_op, store)
    out_ext = store.extents

    fields = {}

    def field_for(op) -> Field:
        f = fields.get(op.arg_pos)
        if f is None:
            f = Field(rename.get(op.arg_name, op.arg_name), op.arg_shape,
                      op.elem_bytes)
            fields[op.arg_pos] = f
        return f

    accesses = []
    for acc in body.accesses:
        if acc.ref_kind != "op":
            continue
        op = traced.operands[acc.ref_index]
        if op.is_output and acc.is_store:
            accesses.append(
                Access(field_for(op), (0,) * len(domain), is_store=True))
            continue
        if op.is_output:
            _reject(traced, f"operand {op.name!r}",
                    "output operand is also read (read-modify-write is not "
                    "a per-point address expression)")
        in_g = _global_exprs(op, acc)
        offsets, coeffs, dim_map = [], [], []
        for j, (cj, ext_j) in enumerate(zip(in_g, acc.extents)):
            placed = False
            if cj.is_const and ext_j == 1:
                offsets.append(cj.const)
                coeffs.append(0)
                dim_map.append(min(j, len(domain) - 1))
                placed = True
            else:
                order = sorted(range(len(domain)),
                               key=lambda d: (d != j, d))
                for d in order:
                    if out_ext[d] != ext_j:
                        continue
                    delta = _const_delta(cj, affine(out_g[d]))
                    if delta is not None:
                        offsets.append(delta)
                        coeffs.append(1)
                        dim_map.append(d)
                        placed = True
                        break
            if not placed:
                _reject(
                    traced, f"operand {op.name!r}",
                    f"access dim {j} (origin {cj!r}, extent {ext_j}) has no "
                    f"constant-offset alignment with any output dimension — "
                    f"not a per-point affine access")
        accesses.append(Access(field_for(op), tuple(offsets),
                               coeffs=tuple(coeffs), dim_map=tuple(dim_map)))
    return KernelSpec(
        name=name or traced.name,
        domain=domain,
        accesses=tuple(accesses),
        flops_per_point=c.flops_per_point,
        work_unit=c.work_unit,
    )


def _try_lower_gemm(traced: TracedKernel, c: CostModel, name, rename):
    """Recognize a blocked GEMM and lower it to the canonical MAC-domain
    spec (one iteration point per multiply-accumulate, domain (K, M, N))."""
    body = traced.body
    mms = body.matmuls
    if not mms:
        return None
    first = mms[0]
    if any((m.m, m.k, m.n) != (first.m, first.k, first.n) for m in mms):
        return None
    lhs, rhs = first.lhs, first.rhs
    if lhs is None or rhs is None or \
            lhs.ref_kind != "op" or rhs.ref_kind != "op" or \
            lhs.ref_index == rhs.ref_index:
        return None
    a_op = traced.operands[lhs.ref_index]
    b_op = traced.operands[rhs.ref_index]
    out_op = traced.outputs[0]
    if a_op.is_output or b_op.is_output:
        return None
    if len(a_op.block_shape) != 2 or len(b_op.block_shape) != 2 or \
            len(out_op.block_shape) != 2:
        return None
    a_g = _global_exprs(a_op, lhs)
    b_g = _global_exprs(b_op, rhs)
    out_store = BodyAccess("op", 0, (0, 0), out_op.block_shape)
    o_g = _global_exprs(out_op, out_store)
    # rows of A follow rows of C, cols of B follow cols of C, and the
    # reduction coordinate is shared between A-cols and B-rows
    if _const_delta(a_g[0], o_g[0]) != 0 or \
            _const_delta(b_g[1], o_g[1]) != 0 or \
            _const_delta(a_g[1], b_g[0]) != 0:
        return None
    M, N = out_op.arg_shape
    K = a_op.arg_shape[1]
    a = Field(rename.get(a_op.arg_name, a_op.arg_name), a_op.arg_shape,
              a_op.elem_bytes)
    b = Field(rename.get(b_op.arg_name, b_op.arg_name), b_op.arg_shape,
              b_op.elem_bytes)
    cf = Field(rename.get(out_op.arg_name, out_op.arg_name),
               out_op.arg_shape, out_op.elem_bytes)
    accesses = (
        Access(a, (0, 0), dim_map=(1, 0)),                  # A[m, k]
        Access(b, (0, 0), dim_map=(0, 2)),                  # B[k, n]
        Access(cf, (0, 0), dim_map=(1, 2), is_store=True),  # C[m, n]
    )
    return KernelSpec(
        name=name or traced.name,
        domain=(K, M, N),
        accesses=accesses,
        flops_per_point=c.flops_per_point if c.flops_per_point else 2.0,
        work_unit=c.work_unit if c.work_unit != "LUP" else "MAC",
    )


__all__ = [
    "CostModel",
    "derive_costs",
    "lower_gpu",
    "lower_tpu",
]
