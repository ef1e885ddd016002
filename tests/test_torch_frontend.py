"""The port's spec frontend (``repro_torch.frontend``) against the reference's
(``repro.frontend``).

The reference traces Pallas builders; the port traces Triton launchers into
the same IR and lowers them with copies of the same code.  So: the affine
IR behaves the same in both packages; hand-built traces lower to equal
specs; a Triton kernel and the Pallas builder at the same tiling give one
payload on the wire and one ranking on every machine; the Triton fixtures'
GPU lowerings are the paper's address expressions (``core.specs``)
exactly; the GEMM's K loop is the Pallas matmul's third grid dimension;
and the stencil's declared TPU candidates are the reference's traced ones.

The reference's tracer patches ``pl.load`` and ``pl.store``, which jax
0.9.0 no longer has: the ``ref_tracer`` fixture gives it a test-only shim
to patch (as ``tests/test_torch_suite.py`` does) and clears the caches the
reference fills under it.
"""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro import frontend as ref_fe  # noqa: E402
from repro.core import tpu_adapt as ref_tpu  # noqa: E402
from repro.frontend import trace as ref_trace  # noqa: E402
from repro.serve import schema as ref_schema  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import frontend as fe  # noqa: E402
from repro_torch.core import tpu_adapt  # noqa: E402
from repro_torch.frontend import tl  # noqa: E402
from repro_torch.frontend import trace  # noqa: E402
from repro_torch.frontend import triton_kernels as T  # noqa: E402
from repro_torch.serve import schema  # noqa: E402

# the modules (each package re-exports a function of the same name)
ref_affine = importlib.import_module("repro.frontend.affine")
affine = importlib.import_module("repro_torch.frontend.affine")
ROOT = Path(__file__).resolve().parents[1]
NAMED = ["H100", "A100", "V100", "TPUv5e"]
#: what a sweep measures of itself, which two sweeps need not agree on
MEASURED = ("wall_time_s", "cache_stats", "metrics")


@pytest.fixture
def ref_tracer(monkeypatch):
    """The reference's tracer, runnable on jax 0.9.0 (a test-only shim for
    the ``pl.load`` / ``pl.store`` it patches); its caches cleared after."""
    from repro.kernels.matmul import generator as ref_mm
    from repro.kernels.stencil3d25 import generator as ref_st
    from repro.kernels.transpose_pad import generator as ref_tr

    def load(ref, idx):
        return ref[idx]

    def store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pl, "load", load, raising=False)
    monkeypatch.setattr(pl, "store", store, raising=False)
    yield
    ref_st._candidates.cache_clear()
    ref_mm._candidates.cache_clear()
    ref_tr.traced_gpu_spec.cache_clear()


def _answer(obj, codec):
    """``codec.encode(obj)`` without the sweep's measurements of itself."""
    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if k not in MEASURED}
        if isinstance(node, list):
            return [strip(x) for x in node]
        return node
    return strip(codec.encode(obj))


# ==========================================================================
# the affine IR, in both packages
# ==========================================================================
@pytest.mark.parametrize("mod", [ref_affine, affine], ids=["repro", "repro_torch"])
def test_affine_arithmetic(mod):
    Sym, aff = mod.Sym, mod.affine
    t = aff(Sym("g0"))
    e = 3 * t + 5 - 1
    assert e.eval({Sym("g0"): 4}) == 16
    assert e.free_syms() == frozenset({Sym("g0")})
    assert (e - e).is_const and (e - e).const == 0
    assert ((4 * t) // 4) == t
    assert ((4 * t + 2) % 2).is_const
    q = (t + 7) // 3
    assert q.eval({Sym("g0"): 2}) == 3
    m = (t + 7) % 3
    assert m.eval({Sym("g0"): 2}) == 0
    c = aff(10).clamp_lo(12)
    assert c.const == 12
    lo = (t - 4).clamp_lo(0)
    assert lo.eval({Sym("g0"): 1}) == 0 and lo.eval({Sym("g0"): 9}) == 5


@pytest.mark.parametrize("mod", [ref_affine, affine], ids=["repro", "repro_torch"])
def test_affine_rejections(mod):
    t, u = mod.affine(mod.Sym("g0")), mod.affine(mod.Sym("g1"))
    with pytest.raises(mod.NonAffineError):
        _ = t * u
    with pytest.raises(mod.NonAffineError):
        _ = t // u
    with pytest.raises(mod.NonAffineError):
        _ = 1 // t
    with pytest.raises(mod.NonAffineError):
        _ = t / 2
    with pytest.raises(mod.NonAffineError):
        int(t)
    with pytest.raises(mod.NonAffineError):
        bool(t < u)
    with pytest.raises(mod.AffineOverflowError):
        _ = t * (1 << 62) * 4  # overflow past the 64-bit address range


def _build(mod, ops):
    """One expression from a list of (op, operand) steps over g0, g1."""
    syms = [mod.affine(mod.Sym(f"g{i}")) for i in range(2)]
    e = syms[0]
    for op, k in ops:
        if op == "add_sym":
            e = e + syms[k % 2] * (k % 5)
        elif op == "add":
            e = e + k
        elif op == "mul":
            e = e * k
        elif op == "floordiv":
            e = e // (abs(k) % 7 + 1)
        elif op == "mod":
            e = e % (abs(k) % 7 + 1)
        elif op == "clamp_lo":
            e = e.clamp_lo(k)
        else:
            e = e.clamp_hi(k)
    return e


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.sampled_from(["add_sym", "add", "mul", "floordiv", "mod",
                                           "clamp_lo", "clamp_hi"]),
                          st.integers(min_value=-9, max_value=9)), max_size=6),
       st.integers(min_value=0, max_value=20), st.integers(min_value=0, max_value=20))
def test_affine_reprs_and_values_equal_across_packages(ops, x, y):
    a, b = _build(ref_affine, ops), _build(affine, ops)
    assert repr(a) == repr(b)
    assert a._key() == b._key()
    assert a.eval({ref_affine.Sym("g0"): x, ref_affine.Sym("g1"): y}) == \
        b.eval({affine.Sym("g0"): x, affine.Sym("g1"): y})
    assert sorted(s.name for s in a.free_syms()) == sorted(s.name for s in b.free_syms())


# --------------------------------------------------------------------------
# the reference's random index-map round trip, as a Triton copy kernel
# --------------------------------------------------------------------------
_EST_FIELDS = ("hbm_bytes", "hbm_time", "mxu_time", "vpu_time", "vmem_time",
               "vmem_alloc_bytes", "grid_overhead", "total_time", "limiter",
               "feasible", "work")


@tl.jit
def _copy_kernel(x_ptr, o_ptr, c00, c01, c02, c10, c11, c12, c20, c21, c22,
                 o0, o1, o2, s0, s1, so0, so1,
                 B0: tl.constexpr, B1: tl.constexpr, B2: tl.constexpr, NG: tl.constexpr):
    g = [tl.program_id(0), tl.program_id(1) if NG > 1 else 0,
         tl.program_id(2) if NG > 2 else 0]
    r0 = (c00 * g[0] + c01 * g[1] + c02 * g[2] + o0) * B0 + tl.arange(0, B0)[:, None, None]
    r1 = (c10 * g[0] + c11 * g[1] + c12 * g[2] + o1) * B1 + tl.arange(0, B1)[None, :, None]
    r2 = (c20 * g[0] + c21 * g[1] + c22 * g[2] + o2) * B2 + tl.arange(0, B2)[None, None, :]
    x = tl.load(x_ptr + r0 * s0 + r1 * s1 + r2)
    tl.store(o_ptr + tl.arange(0, B0)[:, None, None] * so0
             + tl.arange(0, B1)[None, :, None] * so1 + tl.arange(0, B2)[None, None, :], x)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.data())
def test_random_affine_index_map_roundtrip(data):
    """The reference's round trip (``tests/test_frontend.py``): random
    affine index maps, here a Triton copy kernel whose load window is
    ``block * (coeffs . program ids + offset)``, traced by both packages."""
    def load(ref, idx):
        return ref[idx]

    def store(ref, idx, val):
        ref[idx] = val

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "load", load, raising=False)
        mp.setattr(pl, "store", store, raising=False)
        _roundtrip(data)


def _roundtrip(data):
    ngrid = data.draw(st.integers(min_value=1, max_value=3))
    grid = tuple(data.draw(st.integers(min_value=1, max_value=4)) for _ in range(ngrid))
    block = tuple(data.draw(st.sampled_from([1, 2, 4])) for _ in range(3))
    coeffs = [tuple(data.draw(st.integers(min_value=0, max_value=3)) for _ in range(ngrid))
              for _ in range(3)]
    offs = [data.draw(st.integers(min_value=0, max_value=5)) for _ in range(3)]
    arr_shape = tuple(b * max(sum(c * (g - 1) for c, g in zip(cs, grid)) + o + 1, 1)
                      for b, cs, o in zip(block, coeffs, offs))

    def call(x):
        o = x.new_empty(block)
        padded = [cs + (0,) * (3 - ngrid) for cs in coeffs]
        _copy_kernel[grid](x, o, *[c for cs in padded for c in cs], *offs,
                           x.stride(0), x.stride(1), o.stride(0), o.stride(1),
                           B0=block[0], B1=block[1], B2=block[2], NG=ngrid)
        return o

    traced = fe.trace_kernel(call, [fe.arg("x", arr_shape)], name="copy")
    spec = fe.lower_tpu(traced, fe.CostModel(elem_bytes=4))

    def index_map(*g):
        return tuple(sum(c * gi for c, gi in zip(cs, g)) + o for cs, o in zip(coeffs, offs))

    def ref_call(x):
        def kernel(x_ref, o_ref):
            o_ref[...] = x_ref[...]
        return pl.pallas_call(
            kernel, grid=grid, in_specs=[pl.BlockSpec(block, index_map)],
            out_specs=pl.BlockSpec(block, lambda *g: (0, 0, 0)),
            out_shape=jax.ShapeDtypeStruct(block, jnp.float32), interpret=True)(x)

    ref_traced = ref_fe.trace_kernel(ref_call, [ref_fe.arg("x", arr_shape)], name="copy")
    ref_spec = ref_fe.lower_tpu(ref_traced, ref_fe.CostModel(elem_bytes=4))
    x_op, ref_x = traced.operands[0], ref_traced.operands[0]
    assert ref_x.grid_deps == tuple(sorted(d for d in range(ngrid)
                                           if any(cs[d] for cs in coeffs)))
    assert x_op.block_shape == ref_x.block_shape == block
    # a flat offset cannot tell which dimension a symbol of extent 1 (always
    # 0) steps, so the block indices are held equal as functions on the grid,
    # and the grid dependences on the dimensions of extent > 1
    for point in np.ndindex(*grid):
        env = {trace.grid_sym(d): v for d, v in enumerate(point)}
        ref_env = {ref_trace.grid_sym(d): v for d, v in enumerate(point)}
        assert [e.eval(env) for e in x_op.index_exprs] == \
            [e.eval(ref_env) for e in ref_x.index_exprs]

    def live(s, codec):
        return codec.encode(dataclasses.replace(s, operands=tuple(
            dataclasses.replace(o, grid_deps=tuple(d for d in o.grid_deps if grid[d] > 1))
            for o in s.operands)))

    assert live(spec, schema) == live(ref_spec, ref_schema)
    if all(g > 1 for g in grid):
        assert [repr(e) for e in x_op.index_exprs] == [repr(e) for e in ref_x.index_exprs]
        assert schema.encode(spec) == ref_schema.encode(ref_spec)
    # the closed form the reference prices by (its test holds it to the
    # grid-walk oracle, which elides a fetch where the block index repeats
    # on consecutive steps, as at grid (3, 1, 2), block (1, 2, 1), coeffs
    # ((0, 1, 0), (1, 1, 1), (3, 2, 3)), offsets (2, 5, 4): both packages'
    # closed forms count it)
    assert tpu_adapt.fetch_count(grid, x_op.grid_deps) == \
        ref_tpu.fetch_count(grid, ref_x.grid_deps)
    est, ref_est = tpu_adapt.estimate_pallas(spec), ref_tpu.estimate_pallas(ref_spec)
    for f in _EST_FIELDS:
        assert getattr(est, f) == getattr(ref_est, f), f


# ==========================================================================
# lower: hand-built traces, lowered by both packages
# ==========================================================================
def _hand_trace(mod, case):
    """One ``TracedKernel`` in ``mod``'s IR (``mod`` is a frontend.trace)."""
    af = affine if mod is trace else ref_affine
    g = [af.affine(mod.grid_sym(d)) for d in range(3)]
    Op, Acc, Body = mod.TracedOperand, mod.BodyAccess, mod.TracedBody
    if case == "stencil2d":       # a (8, 128) tile of a 5-point sweep, halo windows
        src = Op("src", (10, 130), 8, (af.affine(0), af.affine(0)), (0, 1), False,
                 "src", (66, 258), 0)
        dst = Op("dst", (8, 128), 8, (g[0], g[1]), (0, 1), True, "dst", (64, 256), 1)
        taps = [(1, 1), (0, 1), (2, 1), (1, 0), (1, 2)]
        acc = [Acc("op", 0, (g[0] * 8 + dy, g[1] * 128 + dx), (8, 128)) for dy, dx in taps]
        body = Body(ok=True, accesses=acc + [Acc("op", 1, (0, 0), (8, 128), True)],
                    elementwise_elems=6.0 * 1024)
        return mod.TracedKernel("st", (8, 2), (src, dst), (), body)
    if case == "gemm":
        a = Op("a", (64, 32), 2, (g[0], g[2]), (0, 2), False, "a", (128, 256), 0)
        b = Op("b", (32, 64), 2, (g[2], g[1]), (1, 2), False, "b", (256, 192), 1)
        o = Op("o", (64, 64), 2, (g[0], g[1]), (0, 1), True, "o", (128, 192), 2)
        la, lb = Acc("op", 0, (0, 0), (64, 32)), Acc("op", 1, (0, 0), (32, 64))
        body = Body(ok=True, accesses=[Acc("scratch", 0, (0, 0), (64, 64), True), la, lb,
                                       Acc("op", 2, (0, 0), (64, 64), True)],
                    matmuls=[mod.BodyMatmul(64, 32, 64, la, lb)],
                    elementwise_elems=4096.0)
        return mod.TracedKernel("mm", (2, 3, 8), (a, b, o),
                                (mod.TracedScratch((64, 64), 4),), body)
    if case == "transpose":
        x = Op("x", (32, 64), 4, (g[0], g[1]), (0, 1), False, "x", (64, 128), 0)
        xt = Op("xt", (64, 32), 4, (g[1], g[0]), (0, 1), True, "xt", (128, 64), 1)
        body = Body(ok=True, accesses=[Acc("op", 0, (0, 0), (32, 64)),
                                       Acc("op", 1, (0, 0), (64, 32), True)])
        return mod.TracedKernel("tr", (2, 2), (x, xt), (), body)
    if case == "readback":         # an output read before it is written
        x = Op("x", (16,), 4, (g[0],), (0,), False, "x", (64,), 0)
        o = Op("out", (16,), 4, (g[0],), (0,), True, "out", (64,), 1)
        body = Body(ok=True, accesses=[Acc("op", 0, (0,), (16,)), Acc("op", 1, (0,), (16,)),
                                       Acc("op", 1, (0,), (16,), True)])
        return mod.TracedKernel("rb", (4,), (x, o), (), body)
    if case == "scratch":          # data staged through scratch: TPU only
        x = Op("x", (16,), 4, (g[0],), (0,), False, "x", (64,), 0)
        o = Op("out", (16,), 4, (g[0],), (0,), True, "out", (64,), 1)
        body = Body(ok=True, accesses=[Acc("op", 0, (0,), (16,)),
                                       Acc("scratch", 0, (0,), (16,), True),
                                       Acc("op", 1, (0,), (16,), True)])
        return mod.TracedKernel("sc", (4,), (x, o), (mod.TracedScratch((16,), 4),), body)
    assert case == "untraced"     # no body digest: TPU priced on structure
    x = Op("x", (16, 8), 4, (g[0], af.affine(0)), (0,), False, "x", (64, 8), 0)
    o = Op("out", (16, 8), 4, (g[0], af.affine(0)), (0,), True, "out", (64, 8), 1)
    return mod.TracedKernel("un", (4,), (x, o), (), Body())


def _lowered(frontend, mod, case, costs):
    traced = _hand_trace(mod, case)
    tpu = frontend.lower_tpu(traced, costs and frontend.CostModel(**costs))
    try:
        gpu = frontend.lower_gpu(traced, costs and frontend.CostModel(**costs),
                                 rename={"o": "C"})
    except frontend.TraceError as e:
        gpu = ("rejected", str(e))
    return tpu, gpu


@pytest.mark.parametrize("costs", [None, {"flops_per_point": 3.0, "work_unit": "MAC"},
                                   {"vpu_elems_per_step": 0.0, "vpu_shape": (),
                                    "work_per_step": 7.0, "elem_bytes": 2}])
@pytest.mark.parametrize("case", ["stencil2d", "gemm", "transpose", "readback", "scratch",
                                  "untraced"])
def test_lowering_hand_traces_equals_reference(case, costs):
    tpu, gpu = _lowered(fe, trace, case, costs)
    ref_tpu_spec, ref_gpu = _lowered(ref_fe, ref_trace, case, costs)
    assert schema.encode(tpu) == ref_schema.encode(ref_tpu_spec)
    if isinstance(gpu, tuple):
        assert gpu == ref_gpu
        assert case in ("readback", "scratch", "untraced")
    else:
        assert schema.encode(gpu) == ref_schema.encode(ref_gpu)
        assert case in ("stencil2d", "gemm", "transpose")


def test_derive_costs_equals_reference():
    for case in ("stencil2d", "gemm", "untraced"):
        mine = fe.derive_costs(_hand_trace(trace, case))
        ref = ref_fe.derive_costs(_hand_trace(ref_trace, case))
        assert schema.encode(mine.matmuls_per_step) == ref_schema.encode(ref.matmuls_per_step)
        assert (mine.vpu_elems_per_step, mine.vpu_shape, mine.work_per_step, mine.elem_bytes,
                mine.flops_per_point, mine.work_unit) == (
            ref.vpu_elems_per_step, ref.vpu_shape, ref.work_per_step, ref.elem_bytes,
            ref.flops_per_point, ref.work_unit)


# ==========================================================================
# the headline parity: a Triton kernel and the Pallas builder, one question
# ==========================================================================
def _pallas_scale_shift(Y, X, by, bx, scale=2.0, shift=1.0):
    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * scale + shift

    def call(x):
        return pl.pallas_call(
            kernel, grid=(Y // by, X // bx),
            in_specs=[pl.BlockSpec((by, bx), lambda i, j: (i, j))],
            out_specs=pl.BlockSpec((by, bx), lambda i, j: (i, j)),
            out_shape=jax.ShapeDtypeStruct((Y, X), jnp.float32), interpret=True)(x)

    return call


def _requests(kind):
    if kind == "scale_shift":
        (Y, X), (by, bx) = (256, 512), (16, 256)
        mine = api.kernel_request(T.scale_shift(block=(by, bx)),
                                  [fe.arg("x", (Y, X), torch.float32)], NAMED, name=kind)
        ref = ref_api.kernel_request(_pallas_scale_shift(Y, X, by, bx),
                                     [ref_fe.arg("x", (Y, X), jnp.float32)], NAMED, name=kind)
        return mine, ref
    from repro.kernels.transpose_pad.kernel import make_transpose

    (M, N), (bm, bn) = (256, 512), (64, 64)
    mine = api.kernel_request(T.transpose(block=(bm, bn)),
                              [fe.arg("x", (M, N), torch.float32)], NAMED, name=kind)
    ref = ref_api.kernel_request(make_transpose(M, N, bm, bn, jnp.float32),
                                 [ref_fe.arg("x", (M, N), jnp.float32)], NAMED, name=kind)
    return mine, ref


@pytest.mark.parametrize("kind", ["scale_shift", "transpose"])
def test_kernel_request_matches_reference_wire_and_rankings(kind, ref_tracer):
    mine, ref = _requests(kind)
    assert schema.encode(mine) == ref_schema.encode(ref)
    assert schema.request_digest(mine) == ref_schema.request_digest(ref)
    got, want = api.price(mine), ref_api.price(ref)
    def rows(result, machine):
        return [(getattr(e.config, "block", e.config), getattr(e.config, "folding", None),
                 e.perf, e.limiter) for e in result.ranking(kind, machine)]

    for machine in ("H100-SXM5-80G", "A100-SXM4-40G", "V100-PCIe-32GB", "TPUv5e"):
        assert rows(got, machine), machine
        assert rows(got, machine) == rows(want, machine)
    assert _answer(got, schema) == _answer(want, ref_schema)
    bounds, ref_bounds = api.price_bounds(mine), ref_api.price_bounds(ref)
    assert bounds.degraded and _answer(bounds, schema) == _answer(ref_bounds, ref_schema)


def test_trace_payload_spans_carry_the_reference_names():
    from repro_torch import obs

    obs.reset()
    obs.enable()
    try:
        payload = fe.trace_payload(T.scale_shift(block=(16, 64)),
                                   [fe.arg("x", (64, 128), torch.float32)], name="ss")
    finally:
        obs.disable()
    names = [(r.name, r.cat, r.args.get("kernel")) for r in obs.spans()
             if r.name.startswith("frontend.")]
    obs.reset()
    assert names == [("frontend.trace", "frontend", "ss"), ("frontend.lower", "frontend", "ss")]
    assert payload.tpu_spec.grid == (4, 2) and payload.gpu_spec.domain == (64, 128)


def test_deprecated_price_kernel_warns_and_prices():
    with pytest.warns(DeprecationWarning, match="kernel_request"):
        report = fe.price_kernel(T.scale_shift(block=(16, 64)),
                                 [fe.arg("x", (64, 128), np.float32)], ["H100", "TPUv5e"],
                                 name="ss")
    assert report.best("ss", "H100-SXM5-80G") is not None
    assert report.best("ss", "TPUv5e") is not None


# ==========================================================================
# the paper's address expressions, exactly
# ==========================================================================
FIXTURE_SPECS = [
    ("star", (4, (32, 64, 96)), torch.float64, {}),
    ("star", (2, (8, 16, 24)), torch.float64, {"block": (8, 8)}),
    ("jacobi5", (4096, 4096), torch.float64, {}),
    ("gemm", (512, 1024, 256), torch.bfloat16, {}),
    ("transpose", (256, 512), torch.float32, {}),
    ("transpose", (64, 96), torch.float64, {"block": (32, 32)}),
]


@pytest.mark.parametrize("kind,shape,dtype,tiles", FIXTURE_SPECS,
                         ids=[f"{k}-{i}" for i, (k, *_x) in enumerate(FIXTURE_SPECS)])
def test_fixture_gpu_lowering_is_the_papers_spec(kind, shape, dtype, tiles):
    spec = T.traced_gpu_spec(kind, shape, dtype, **tiles)
    hand = T.hand_spec(kind, shape, dtype.itemsize)
    assert spec == hand
    assert schema.encode(spec) == schema.encode(hand)


@pytest.mark.parametrize("kind,shape,dtype", [
    ("star", (4, (32, 64, 96)), torch.float64), ("star", (2, (8, 16, 24)), torch.float64),
    ("jacobi5", (4096, 4096), torch.float64), ("gemm", (512, 1024, 256), torch.bfloat16),
    ("transpose", (256, 512), torch.float32)])
def test_fixture_gpu_lowering_equals_reference_trace(kind, shape, dtype, ref_tracer):
    """The same specs from the reference's own Pallas traces (its
    ``traced_gpu_spec``s, ``tests/test_frontend.py:246-280``)."""
    from repro.kernels.jacobi2d.generator import traced_gpu_spec as ref_jacobi
    from repro.kernels.matmul.generator import traced_gpu_spec as ref_gemm
    from repro.kernels.stencil3d25.generator import traced_gpu_spec as ref_star
    from repro.kernels.transpose_pad.generator import traced_gpu_spec as ref_transpose

    eb = dtype.itemsize
    ref = {"star": lambda: ref_star(shape[0], shape[1], eb),
           "jacobi5": lambda: ref_jacobi(shape, eb, name="stencil2d5pt"),
           "gemm": lambda: ref_gemm(*shape, eb),
           "transpose": lambda: ref_transpose(shape, eb)}[kind]()
    tiles = {"block": (8, 8)} if kind == "star" and shape[0] == 2 else {}
    assert schema.encode(T.traced_gpu_spec(kind, shape, dtype, **tiles)) == \
        ref_schema.encode(ref)


def test_transpose_dim_map():
    """The four checks of the reference's ``test_gpu_lowering_transpose_dim_map``."""
    spec = T.traced_gpu_spec("transpose", (256, 512), torch.float32)
    assert spec.domain == (512, 256)        # out shape (N, M)
    load, store = spec.accesses
    assert not load.is_store and store.is_store
    assert load.dim_map == (1, 0)           # in[p1, p0]
    assert store.dim_map == (0, 1)


def test_fixture_traces_record_masks_and_windows():
    call, args, kw, _costs, _rename = T.traced("jacobi5", (64, 256), torch.float64)
    traced = fe.trace_kernel(call, args, trace_body=True, **kw)
    assert traced.grid == (8, 2)
    src, dst = traced.operands
    assert (src.block_shape, src.grid_deps, src.is_output) == ((10, 130), (0, 1), False)
    assert (dst.block_shape, dst.index_exprs, dst.is_output) == (
        (8, 128), (fe.affine(trace.grid_sym(0)), fe.affine(trace.grid_sym(1))), True)
    loads = traced.body.loads("op")
    g0, g1 = (fe.affine(trace.grid_sym(d)) for d in range(2))
    assert [a.offsets for a in loads] == [(g0 * 8 + dy, g1 * 128 + dx) for dy, dx in
                                          ((1, 1), (0, 1), (2, 1), (1, 0), (1, 2))]
    assert traced.body.masked == list(range(6))          # every access carried a mask
    assert traced.body.elementwise_elems == 6.0 * 8 * 128


# ==========================================================================
# the GEMM: its K loop is the Pallas matmul's third grid dimension
# ==========================================================================
@tl.jit
def _gemm_tutorial_kernel(a_ptr, b_ptr, c_ptr, M, N, K, s_am, s_ak, s_bk, s_bn, s_cm, s_cn,
                          BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
    """The Triton tutorial's form: offsets wrapped by ``% M`` (the identity
    on the grid, which the tracer's ranges show) and pointers advanced by
    the loop."""
    offs_am = (tl.program_id(0) * BM + tl.arange(0, BM)) % M
    offs_bn = (tl.program_id(1) * BN + tl.arange(0, BN)) % N
    offs_m = tl.program_id(0) * BM + tl.arange(0, BM)
    offs_n = tl.program_id(1) * BN + tl.arange(0, BN)
    offs_k = tl.arange(0, BK)
    a_ptrs = a_ptr + offs_am[:, None] * s_am + offs_k[None, :] * s_ak
    b_ptrs = b_ptr + offs_k[:, None] * s_bk + offs_bn[None, :] * s_bn
    acc = tl.zeros((BM, BN), dtype=tl.float32)
    for _k in tl.range(0, tl.cdiv(K, BK)):
        a = tl.load(a_ptrs)
        b = tl.load(b_ptrs)
        acc = tl.dot(a, b, acc)
        a_ptrs += BK * s_ak
        b_ptrs += BK * s_bk
    tl.store(c_ptr + offs_m[:, None] * s_cm + offs_n[None, :] * s_cn,
             acc.to(c_ptr.dtype.element_ty))


def _gemm_tutorial(bm, bn, bk):
    def call(a, b):
        (M, K), N = a.shape, b.shape[1]
        c = a.new_empty((M, N))
        _gemm_tutorial_kernel[(M // bm, N // bn)](
            a, b, c, M, N, K, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            c.stride(0), c.stride(1), BM=bm, BN=bn, BK=bk)
        return c
    return call


@pytest.mark.parametrize("tiles", [(128, 64, 128), (64, 128, 32), (256, 256, 128)])
def test_gemm_tpu_spec_equals_reference_traced_matmul(tiles, ref_tracer):
    """Grid, operands, matmuls and scratch of the traced Triton GEMM equal
    the reference's traced ``make_matmul`` at the same tiles.  Without a
    cost model both count ``acc += dot`` as bm x bn VPU elements a step (the
    Pallas ``acc[...] +=``); the zero-init and the cast count nothing in
    either, so ``vpu_elems_per_step`` is equal too (bm x bn)."""
    from repro.kernels.matmul.kernel import make_matmul

    bm, bk, bn = tiles
    M, K, N = 512, 1024, 256
    args = [fe.arg("a", (M, K), torch.bfloat16), fe.arg("b", (K, N), torch.bfloat16)]
    mine = fe.lower_tpu(fe.trace_kernel(T.gemm(block=(bm, bn, bk)), args, name="mm",
                                        out_names=("o",), trace_body=True))
    ref = ref_fe.lower_tpu(ref_fe.trace_kernel(
        make_matmul(M, K, N, bm, bk, bn, jnp.bfloat16),
        [ref_fe.arg("a", (M, K), jnp.bfloat16), ref_fe.arg("b", (K, N), jnp.bfloat16)],
        name="mm", out_names=("o",), trace_body=True))
    assert mine.grid == ref.grid == (M // bm, N // bn, K // bk)
    assert mine.operands == tuple(tpu_adapt.OperandSpec(**dataclasses.asdict(o))
                                  for o in ref.operands)
    assert mine.matmuls_per_step == (tpu_adapt.MatmulShape(bm, bk, bn),)
    assert mine.scratch_bytes == ref.scratch_bytes == bm * bn * 4
    assert mine.vpu_elems_per_step == ref.vpu_elems_per_step == float(bm * bn)
    assert schema.encode(mine) == ref_schema.encode(ref)
    # the tutorial's loop-advanced pointers trace to the same spec
    tutorial = fe.lower_tpu(fe.trace_kernel(_gemm_tutorial(bm, bn, bk), args, name="mm",
                                            out_names=("o",), trace_body=True))
    assert dataclasses.replace(tutorial, vpu_elems_per_step=mine.vpu_elems_per_step) == mine
    assert tutorial.vpu_elems_per_step == 0.0      # tl.dot(a, b, acc) adds in the MMA


def test_gemm_grid_dimension_of_extent_one_steps_nothing(ref_tracer):
    """At K == bk the loop runs once: its grid dimension has extent 1, and a
    flat offset cannot show which dimension its symbol (always 0) would
    step, so the port's operands do not depend on it where the reference's
    do; the two specs price the same."""
    from repro.kernels.matmul.kernel import make_matmul

    M, K, N, bm, bn = 256, 128, 256, 128, 128
    mine = fe.lower_tpu(fe.trace_kernel(
        T.gemm(block=(bm, bn, K)), [fe.arg("a", (M, K), torch.bfloat16),
                                    fe.arg("b", (K, N), torch.bfloat16)],
        name="mm", out_names=("o",), trace_body=True))
    ref = ref_fe.lower_tpu(ref_fe.trace_kernel(
        make_matmul(M, K, N, bm, K, bn, jnp.bfloat16),
        [ref_fe.arg("a", (M, K), jnp.bfloat16), ref_fe.arg("b", (K, N), jnp.bfloat16)],
        name="mm", out_names=("o",), trace_body=True))
    assert mine.grid == ref.grid == (2, 2, 1)
    assert [o.grid_deps for o in mine.operands] == [(0,), (1,), (0, 1)]
    assert [o.grid_deps for o in ref.operands] == [(0, 2), (1, 2), (0, 1)]
    est, ref_est = tpu_adapt.estimate_pallas(mine), ref_tpu.estimate_pallas(ref)
    for f in _EST_FIELDS:
        assert getattr(est, f) == getattr(ref_est, f), f
    gpu = fe.lower_gpu(fe.trace_kernel(
        T.gemm(block=(bm, bn, K)), [fe.arg("a", (M, K), torch.bfloat16),
                                    fe.arg("b", (K, N), torch.bfloat16)],
        name="g", out_names=("o",), trace_body=True))
    assert gpu.domain == (K, M, N)          # still the blocked GEMM


def test_gemm_traced_body_and_gpu_lowering():
    traced = fe.trace_kernel(T.gemm(block=(64, 64, 32)),
                             [fe.arg("a", (128, 96), torch.bfloat16),
                              fe.arg("b", (96, 192), torch.bfloat16)],
                             name="g", out_names=("o",), trace_body=True)
    assert traced.grid == (2, 3, 3)
    assert traced.scratch == (trace.TracedScratch((64, 64), 4),)
    [mm] = traced.body.matmuls
    assert (mm.m, mm.k, mm.n) == (64, 32, 64)
    assert mm.lhs.ref_index == 0 and mm.rhs.ref_index == 1
    assert [a.ref_kind for a in traced.body.accesses] == ["op", "op", "scratch", "scratch",
                                                          "op"]
    gpu = fe.lower_gpu(traced, fe.CostModel(flops_per_point=2.0, work_unit="MAC"),
                       name="gemm_128x96x192", rename={"a": "A", "b": "B", "o": "C"})
    from repro_torch.core.specs import matmul_naive

    assert gpu == matmul_naive(128, 96, 192, 2)


# ==========================================================================
# the stencil's declared TPU candidates
# ==========================================================================
@pytest.mark.parametrize("r,domain,eb", [(2, (16, 64, 128), 4), (4, (512, 512, 640), 8),
                                         (1, (8, 16, 32), 8), (4, (64, 96, 128), 4)])
def test_stencil_declared_tpu_specs_equal_traced_reference(r, domain, eb, ref_tracer):
    from repro.kernels.stencil3d25.generator import candidate_specs
    from repro_torch.kernels.stencil3d25.generator import tpu_candidate_specs

    mine, ref = list(tpu_candidate_specs(r, domain, eb)), list(candidate_specs(r, domain, eb))
    assert [c for c, _ in mine] == [c for c, _ in ref]
    assert schema.encode(mine) == ref_schema.encode(ref)
    assert all(a is b for (_, a), (_, b) in zip(mine, tpu_candidate_specs(r, domain, eb)))


# ==========================================================================
# the fixtures' plain versions against the reference's functions
# ==========================================================================
def test_fixture_plain_versions_equal_reference_functions():
    from repro.kernels.jacobi2d.ops import jacobi_ref as ref_jacobi
    from repro.kernels.stencil3d25.ref import pad_input as ref_pad
    from repro.kernels.stencil3d25.ref import star_stencil_ref as ref_star

    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 72)).astype(np.float32)
    got = T.scale_shift(block=(8, 32))(torch.from_numpy(x))
    want = _pallas_scale_shift(40, 72, 8, 24)(jnp.asarray(x))
    # XLA may fuse the multiply-add into one rounding: an ulp of 2x apart
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    with jax.enable_x64(True):
        src = rng.standard_normal((24, 40))
        got = T.jacobi5()(torch.nn.functional.pad(torch.from_numpy(src), (1, 1, 1, 1)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_jacobi(jnp.asarray(src))),
                                   rtol=1e-12, atol=1e-12)
        for r in (1, 2, 4):
            field = rng.standard_normal((10, 12, 14))
            w = T.STAR_WEIGHTS
            # the reference's weights: centre, then +-o along z, y and x
            full = [w[0]] + [w[o] for _axis in range(3) for o in range(1, r + 1) for _s in (0, 1)]
            padded = ref_pad(jnp.asarray(field), r)
            want = ref_star(padded, jnp.asarray(full), r)
            got = T.star(r)(torch.from_numpy(np.array(padded)))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)

    x = rng.standard_normal((24, 40)).astype(np.float32)
    np.testing.assert_array_equal(T.transpose()(torch.from_numpy(x)).numpy(), x.T)
    a = rng.standard_normal((32, 48)).astype(np.float32)
    b = rng.standard_normal((48, 16)).astype(np.float32)
    got = T.gemm()(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.dot(a, b)), rtol=1e-5, atol=1e-4)
    assert all(n == 0 for n in T.LAUNCHES.values())   # a CPU tensor launches nothing


# ==========================================================================
# the package boundary, the stand-in, the example
# ==========================================================================
def test_frontend_import_loads_neither_torch_nor_triton():
    code = ("import sys, repro_torch.frontend, repro_torch.frontend.tl; "
            "print('torch' in sys.modules, any(m == 'triton' or m.startswith('triton.') "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    assert out == ["False", "False"]


def test_stand_in_refuses_to_run_outside_a_trace():
    with pytest.raises(RuntimeError, match="outside a trace"):
        tl.load(None)
    with pytest.raises(RuntimeError, match="outside a trace"):
        tl.program_id(0)
    with pytest.raises(RuntimeError, match="outside a trace"):
        T.scale_shift_kernel[(1, 1)]
    with pytest.raises(RuntimeError, match="outside a kernel"):
        T.scale_shift_kernel()
    with pytest.raises(RuntimeError, match="Triton is not installed"):
        T.scale_shift()(torch.empty((4, 4), device="meta"))
    assert tl.cdiv(10, 4) == 3 and tl.constexpr(5) == 5
    assert tl.float32.itemsize == 4 and tl.dtype_of(torch.bfloat16) is tl.bfloat16


def test_untraced_body_keeps_structure_and_candidates_sweep():
    call, args, kw, _c, _r = T.traced("transpose", (128, 256), torch.float32)
    traced = fe.trace_kernel(call, args, **kw)
    assert not traced.body.ok and traced.body.accesses == []
    assert [o.block_shape for o in traced.operands] == [(64, 64), (64, 64)]
    spec = fe.lower_tpu(traced)
    assert spec.vpu_elems_per_step == 0.0 and spec.matmuls_per_step == ()
    with pytest.raises(fe.TraceError, match="not traced"):
        fe.lower_gpu(traced)

    def build(cfg):
        return fe.KernelBuild(T.transpose(block=(cfg["bm"], cfg["bn"])),
                              (fe.arg("x", (128, 256), torch.float32),), name="tr",
                              trace_body=True)

    pairs = list(fe.candidates(build, fe.grid_space(bm=[32, 64], bn=[64])))
    assert [c for c, _ in pairs] == [{"bm": 32, "bn": 64}, {"bm": 64, "bn": 64}]
    assert [s.grid for _, s in pairs] == [(4, 4), (2, 4)]


def _example():
    examples = str(ROOT / "examples")
    sys.path.insert(0, examples)
    try:
        import torch_price_my_kernel
    finally:
        sys.path.remove(examples)
    return torch_price_my_kernel


def test_price_my_kernel_example_on_the_cpu(capsys, ref_tracer):
    ex = _example()
    out = ex.main(device="cpu", shape=(64, 512), block=(16, 256))
    assert out["ulps"] == 0.0 and out["max_abs_err"] == 0.0
    assert out["traced"].grid == (4, 2)
    ref = ref_api.kernel_request(_pallas_scale_shift(64, 512, 16, 256),
                                 [ref_fe.arg("x", (64, 512), jnp.float32)],
                                 list(ex.MACHINES), name="scale_shift")
    want = ref_api.price(ref)
    assert _answer(out["result"], schema) == _answer(want, ref_schema)
    text = capsys.readouterr().out
    assert "traced address expressions" in text and "the plain version" in text
    for name in ("V100-PCIe-32GB", "A100-SXM4-40G", "H100-SXM5-80G", "TPUv5e"):
        assert name in text


def test_price_my_kernel_example_never_falls_back_to_the_cpu(monkeypatch):
    ex = _example()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(shape=(64, 512))


def test_smoke_frontend_phase_runs_on_the_cpu_at_reduced_size(monkeypatch, capsys):
    """``chip_smoke.run_frontend`` on the CPU: the card's timings stubbed,
    the launchers counted where they run their plain versions, an empty
    stand-in for the ``triton`` package, the example and the fixtures at
    small sizes; F1-F3 run, every fixture's spec equal to ``core.specs``',
    the daemon's answer equal to in-process ``price()`` on the wire."""
    import argparse
    import types

    import chip_smoke

    ex = _example()
    monkeypatch.setitem(sys.modules, "triton", types.ModuleType("triton"))
    sys.modules["triton"].__version__ = "a stand-in"
    plain = T._launches

    def launches(x, name):
        if x.device.type == "cpu":
            T.LAUNCHES[name] += 1
            return False
        return plain(x, name)

    monkeypatch.setattr(T, "_launches", launches)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda torch, fn, warmup=3, reps=20: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "interleaved_ms",
                        lambda torch, fns, rounds, calls=1: {k: (f(), 1.0)[1] for k, f in fns.items()})
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "the CPU")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "FRONTEND_FIXTURES", (
        ("jacobi5", (64, 256), "float64", "j"), ("star", (4, (12, 16, 64)), "float64", "s"),
        ("gemm", (128, 256, 128), "bfloat16", "g"), ("transpose", (128, 256), "float32", "t")))
    main = ex.main
    monkeypatch.setattr(ex, "main", lambda device="cuda", **kw: main(device, shape=(64, 512), **kw))
    records = chip_smoke.run_frontend(argparse.Namespace(seed=0), torch, torch.device("cpu"))
    out = capsys.readouterr().out.splitlines()
    assert [r["name"] for r in records] == ["scale_shift_kernel", "jacobi5_kernel", "star_kernel",
                                            "gemm_kernel", "transpose_kernel"]
    assert all(r["route"] == "triton" and r["launches"] == 1 for r in records)
    assert all({"ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                "replaces", "source", "counterpart_of"} <= set(r) for r in records)
    # the fixtures replace no TPU kernel: the CUDA kernels do
    assert all(r["replaces"] is None and r["counterpart_of"] for r in records)
    assert sum(line.startswith("frontend F2") for line in out) == 4
    assert any(line.startswith("frontend F3") and "equal on the wire" in line for line in out)
