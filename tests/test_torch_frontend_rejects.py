"""The port's tracer rejections, in Triton form, surface as the reference's
diagnostics.

One test a rejection class of the reference's ``tests/test_frontend_rejects
.py`` (a non-affine offset, a data-dependent grid, data-dependent
addressing, a scratch-staged kernel on the GPU, a build error, a launcher
with nothing to trace), each a Triton kernel under the stand-in
``repro_torch.frontend.tl``: every class raises or records a ``TraceError``
naming the offending argument with the reference's wording, and flows
through the exploration engine as a ``report.skipped`` reason rather than an
exception mid-sweep.  Then what only a Triton tracer meets: a nested loop,
an unknown ``tl`` function, ``tl.extra``, an ``@autotune`` wrapper, two
launches, an offset that does not split, and the signed halo split.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core.engine import Explorer, RejectedSpec, Workload  # noqa: E402
from repro_torch.core.machines import TPU_V5E, V100  # noqa: E402
from repro_torch.frontend import (  # noqa: E402
    KernelBuild,
    TraceError,
    arg,
    candidates,
    lower_gpu,
    price_kernel,
    trace_kernel,
)
from repro_torch.frontend import tl  # noqa: E402
from repro_torch.frontend import triton_kernels as T  # noqa: E402
from repro_torch.frontend.trace import grid_sym  # noqa: E402

affine = __import__("repro_torch.frontend.affine", fromlist=["affine"]).affine


@tl.jit
def _copy(x_ptr, o_ptr, SQUARE: tl.constexpr, BM: tl.constexpr, BN: tl.constexpr):
    pid = tl.program_id(0)
    rows = (pid * pid if SQUARE else pid) * BM + tl.arange(0, BM)[:, None]
    cols = tl.arange(0, BN)[None, :]
    x = tl.load(x_ptr + rows * BN + cols)
    tl.store(o_ptr + (pid * BM + tl.arange(0, BM)[:, None]) * BN + cols, x)


def _copy_call(grid, square=False, shape=(32, 8)):
    def call(x):
        o = x.new_empty(shape)
        _copy[grid](x, o, SQUARE=square, BM=8, BN=8)
        return o
    return call


def _explore_skips(build):
    """Run one candidate through candidates() + Explorer; return skips."""
    pairs = list(candidates(lambda cfg: build, [{"case": 0}]))
    assert len(pairs) == 1
    assert isinstance(pairs[0][1], RejectedSpec)
    report = api.price(api.PriceRequest(
        workloads=[Workload("rejected", tpu_candidates=pairs)], machines=[TPU_V5E]),
        engine=Explorer()).report
    assert not report.entries
    skips = report.skipped_for("rejected")
    assert len(skips) == 1
    return skips[0]


def test_copy_kernel_traces():
    traced = trace_kernel(_copy_call((4,)), [arg("x", (32, 8))], name="copy",
                          trace_body=True)
    assert [(o.name, o.block_shape, o.grid_deps) for o in traced.operands] == [
        ("x", (8, 8), (0,)), ("out", (8, 8), (0,))]


def test_reject_nonaffine_offset():
    call = _copy_call((4,), square=True)
    with pytest.raises(TraceError) as exc:
        trace_kernel(call, [arg("x", (128, 8))], name="quadratic")
    msg = str(exc.value)
    assert "argument 'x'" in msg and "non-affine" in msg
    skip = _explore_skips(KernelBuild(call, (arg("x", (128, 8)),), name="quadratic"))
    assert "non-affine" in skip.reason and "'x'" in skip.reason


def test_reject_data_dependent_grid():
    def call(x):
        o = x.new_empty((32, 8))
        n = x.new_zeros(()) + 4          # a tensor, not a static Python int
        _copy[(n,)](x, o, SQUARE=False, BM=8, BN=8)
        return o

    with pytest.raises(TraceError) as exc:
        trace_kernel(call, [arg("x", (32, 8))], name="dyngrid")
    assert "data-dependent grid" in str(exc.value)
    skip = _explore_skips(KernelBuild(call, (arg("x", (32, 8)),), name="dyngrid"))
    assert "data-dependent grid" in skip.reason


def test_callable_grid_takes_the_launch_meta():
    def call(x):
        o = x.new_empty((32, 8))
        _copy[lambda meta: (32 // meta["BM"],)](x, o, SQUARE=False, BM=8, BN=8)
        return o

    assert trace_kernel(call, [arg("x", (32, 8))], name="meta").grid == (4,)


@tl.jit
def _gather(x_ptr, i_ptr, o_ptr, BN: tl.constexpr):
    pid = tl.program_id(0)
    row = tl.load(i_ptr + pid)                 # an address from loaded data
    x = tl.load(x_ptr + row * BN + tl.arange(0, BN))
    tl.store(o_ptr + pid * BN + tl.arange(0, BN), x)


def _gather_call(x, idx):
    o = x.new_empty((4, 8))
    _gather[(4,)](x, idx, o, BN=8)
    return o


def test_reject_data_dependent_pointer():
    args = [arg("x", (32, 8)), arg("idx", (4,), np.int32)]
    with pytest.raises(TraceError) as exc:
        trace_kernel(_gather_call, args, name="gather", trace_body=True, require_body=True)
    msg = str(exc.value)
    assert "argument 'x'" in msg and "data-dependent" in msg
    # without require_body the diagnostic is recorded, not raised ...
    traced = trace_kernel(_gather_call, args, name="gather", trace_body=True)
    assert not traced.body.ok and "data-dependent" in traced.body.error
    # ... the argument the body never reached is taken whole ...
    assert [(o.name, o.block_shape) for o in traced.operands] == [("x", (32, 8)),
                                                                    ("idx", (1,))]
    # ... and the GPU lowering turns it into a TraceError
    with pytest.raises(TraceError, match="data-dependent"):
        lower_gpu(traced)


@tl.jit
def _row_sum(x_ptr, o_ptr, K, BM: tl.constexpr, BK: tl.constexpr):
    rows = tl.program_id(0) * BM + tl.arange(0, BM)
    acc = tl.zeros((BM,), dtype=tl.float32)
    for k in range(0, K, BK):
        x = tl.load(x_ptr + rows[:, None] * K + (k + tl.arange(0, BK))[None, :])
        acc += tl.sum(x, axis=1)
    tl.store(o_ptr + rows, acc)


def _row_sum_call(x):
    o = x.new_empty((x.shape[0],))
    _row_sum[(x.shape[0] // 16,)](x, o, x.shape[1], BM=16, BK=32)
    return o


def test_reject_scratch_staged_gpu_lowering():
    traced = trace_kernel(_row_sum_call, [arg("x", (64, 128))], name="rowsum",
                          trace_body=True)
    assert traced.body.ok and traced.grid == (4, 4)
    assert traced.scratch[0].shape == (16,)
    with pytest.raises(TraceError, match="scratch"):
        lower_gpu(traced)


def test_price_kernel_reports_gpu_rejection():
    """A kernel only the TPU lowering takes still prices on the TPU; the GPU
    machines get the tracer's diagnostic as their skip reason."""
    with pytest.warns(DeprecationWarning):
        report = price_kernel(_row_sum_call, [arg("x", (64, 128))],
                              machines=[V100, TPU_V5E], name="rowsum")
    assert report.best("rowsum", TPU_V5E.name) is not None
    skips = report.skipped_for("rowsum", V100.name)
    assert len(skips) == 1 and "scratch" in skips[0].reason
    served = api.price(api.kernel_request(_row_sum_call, [arg("x", (64, 128))],
                                          [V100, TPU_V5E], name="rowsum"))
    assert "scratch" in served.report.skipped_for("rowsum", V100.name)[0].reason


def test_reject_build_error_recorded():
    def build(cfg):
        # 100 is not a power of two -> the launcher factory raises ValueError
        return KernelBuild(T.gemm(block=(cfg["bm"], 128, 128)),
                           (arg("a", (128, 128)), arg("b", (128, 128))), name="bad")

    pairs = list(candidates(build, [{"bm": 100}]))
    assert isinstance(pairs[0][1], RejectedSpec)
    assert "build failed" in pairs[0][1].reason


def test_launcher_without_a_launch_gets_contract_diagnostic():
    with pytest.raises(TraceError, match="never launched"):
        trace_kernel(lambda x: x * 2, [arg("x", (32, 8))], name="nolaunch")


def test_reject_two_launches():
    def call(x):
        o = _copy_call((4,))(x)
        return _copy_call((4,))(o)

    with pytest.raises(TraceError, match="more than one kernel"):
        trace_kernel(call, [arg("x", (32, 8))], name="twice")


# --------------------------------------------------------------------------
# what only a Triton tracer meets
# --------------------------------------------------------------------------
@tl.jit
def _loops(x_ptr, o_ptr, K, NESTED: tl.constexpr, TWICE: tl.constexpr, BK: tl.constexpr):
    acc = tl.zeros((BK,), dtype=tl.float32)
    for k in tl.range(0, K, BK):
        if NESTED:
            for j in tl.static_range(2):
                acc += tl.load(x_ptr + k + j + tl.arange(0, BK))
        else:
            acc += tl.load(x_ptr + k + tl.arange(0, BK))
    if TWICE:
        for k in range(0, K, BK):
            acc += tl.load(x_ptr + k + tl.arange(0, BK))
    tl.store(o_ptr + tl.arange(0, BK), acc)


@pytest.mark.parametrize("nested,twice,match", [(True, False, "nested loops"),
                                                (False, True, "second range")])
def test_reject_nested_and_second_loops(nested, twice, match):
    def call(x):
        o = x.new_empty((16,))
        _loops[(1,)](x, o, x.shape[0], NESTED=nested, TWICE=twice, BK=16)
        return o

    with pytest.raises(TraceError, match=match):
        trace_kernel(call, [arg("x", (128,))], name="loops", trace_body=True,
                     require_body=True)


def test_one_loop_is_the_trailing_grid_dimension():
    def call(x):
        o = x.new_empty((16,))
        _loops[(1,)](x, o, x.shape[0], NESTED=False, TWICE=False, BK=16)
        return o

    traced = trace_kernel(call, [arg("x", (128,))], name="loop", trace_body=True)
    assert traced.grid == (1, 8)
    x = traced.operands[0]
    assert (x.block_shape, x.index_exprs, x.grid_deps) == ((16,), (affine(grid_sym(1)),), (1,))


@tl.jit
def _unknown(x_ptr, o_ptr, BN: tl.constexpr, WHICH: tl.constexpr):
    x = tl.load(x_ptr + tl.arange(0, BN))
    if WHICH == "cumsum":
        x = tl.cumsum(x, 0)
    else:
        x = tl.extra.cuda.libdevice.erf(x)
    tl.store(o_ptr + tl.arange(0, BN), x)


@pytest.mark.parametrize("which,named", [("cumsum", "tl.cumsum"),
                                         ("extra", "triton.language.extra")])
def test_reject_unsupported_tl_function_by_name(which, named):
    def call(x):
        o = x.new_empty(x.shape)
        _unknown[(1,)](x, o, BN=16, WHICH=which)
        return o

    with pytest.raises(TraceError, match=named.replace(".", r"\.")):
        trace_kernel(call, [arg("x", (16,))], name="unknown", trace_body=True,
                     require_body=True)


def test_reject_autotune_wrapper_by_name():
    tuned = tl.autotune(configs=[tl.Config({"BM": 8})], key=[])(_copy)

    def call(x):
        o = x.new_empty((32, 8))
        tuned[(4,)](x, o, SQUARE=False, BN=8)
        return o

    with pytest.raises(TraceError, match="Autotuner"):
        trace_kernel(call, [arg("x", (32, 8))], name="tuned")


@tl.jit
def _flat(x_ptr, o_ptr, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    tl.store(o_ptr + offs, tl.load(x_ptr + offs))


def test_reject_flat_offset_that_does_not_split():
    """A 1D block walking a 2D array row over row: its window is no box of
    the array, so the offset does not split into the array's dimensions."""
    def call(x):
        o = x.new_empty(x.shape)
        _flat[(x.numel() // 16,)](x, o, BLOCK=16)
        return o

    with pytest.raises(TraceError, match="does not split"):
        trace_kernel(call, [arg("x", (8, 32))], name="flat", trace_body=True,
                     require_body=True)
    # over a flat view of the same array it is one window a program
    traced = trace_kernel(lambda x: call(x.view(-1)), [arg("x", (8, 32))], name="flat",
                          trace_body=True, require_body=True)
    assert [(o.name, o.block_shape, o.arg_shape) for o in traced.operands] == [
        ("x", (16,), (256,)), ("out", (16,), (256,))]


@tl.jit
def _halo(x_ptr, o_ptr, X, BY: tl.constexpr, BX: tl.constexpr):
    rows = tl.program_id(0) * BY + tl.arange(0, BY)[:, None]
    cols = tl.program_id(1) * BX + tl.arange(0, BX)[None, :]
    inside = (rows > 0) & (cols > 0)
    nw = tl.load(x_ptr + rows * X + cols - X - 1, mask=inside, other=0.0)
    tl.store(o_ptr + rows * X + cols, nw)


def test_signed_halo_tap_splits_into_minus_one_minus_one():
    """The north-west tap ``- X - 1`` of an unpadded field is one row up and
    one column left: origins (-1, -1) from the tile's, not (-2, X - 1)."""
    def call(x):
        o = x.new_empty(x.shape)
        _halo[(4, 2)](x, o, x.shape[1], BY=8, BX=16)
        return o

    traced = trace_kernel(call, [arg("x", (32, 32))], name="halo", trace_body=True,
                          require_body=True)
    load = traced.body.loads("op")[0]
    g0, g1 = affine(grid_sym(0)), affine(grid_sym(1))
    x = traced.operands[0]
    origins = [e * b + o for e, b, o in zip(x.index_exprs, x.block_shape, load.offsets)]
    assert origins == [g0 * 8 - 1, g1 * 16 - 1]
    assert load.extents == (8, 16) and traced.body.masked == [0]
    spec = lower_gpu(traced)
    assert spec.accesses[0].offsets == (-1, -1)
