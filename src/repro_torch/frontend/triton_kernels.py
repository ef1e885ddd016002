"""Triton fixtures of the spec frontend: real Triton kernels it traces.

Each is the Triton counterpart of a kernel the reference's tracer derives a
spec from, with its launcher (the closure around ``kernel[grid](...)``)
and a plain PyTorch version beside it:

  * ``scale_shift`` — ``out = x * scale + shift`` over (BY, BX) tiles, the
    kernel of ``examples/price_my_kernel.py``;
  * ``jacobi5`` — the weighted 5-point Jacobi sweep on a halo-1 padded
    field, whose GPU lowering is ``core.specs.stencil_2d5pt``;
  * ``star`` — the range-r 3D star stencil, one point a lane, (BY, BX)
    tiles of one z-plane a program, whose GPU lowering is
    ``core.specs.star_stencil_3d`` (weights one a distance, as Triton
    takes no tuple of them: ``w0`` the centre, ``w1``-``w4`` the rings);
  * ``transpose`` — an (M, N) to (N, M) transpose over (BM, BN) tiles,
    whose GPU lowering is ``core.specs.transpose_pad``;
  * ``gemm`` — a blocked GEMM whose K loop becomes the third grid dimension
    of the Pallas matmul's spec, and whose GPU lowering is
    ``core.specs.matmul_naive``.

They are fixtures: nothing on a main path calls them.  Block sizes are
powers of two, and on the card each compiles under ``@triton.jit`` and
launches.  Where Triton is not installed the module imports the stand-in
``repro_torch.frontend.tl``, which only traces.  A launcher runs the plain
version on a CPU tensor, launches the kernel on a CUDA one (adding one to
``LAUNCHES``), and on the tracer's ``meta`` tensors makes the launch the
trace captures.  ``traced_gpu_spec`` / ``hand_spec`` give each fixture's
traced GPU lowering and the ``core.specs`` spec it must equal.
"""
from __future__ import annotations

try:
    import triton
    import triton.language as tl
except ImportError:  # no Triton on this machine: the stand-in only traces
    from repro_torch.frontend import tl

    triton = tl

LAUNCHES = {"scale_shift": 0, "jacobi5": 0, "star": 0, "transpose": 0,
            "gemm": 0}

# the tiles each launcher takes by default (the chip smoke's)
SCALE_SHIFT_BLOCK = (16, 256)          # (BY, BX), 4 warps
JACOBI_BLOCK = (8, 128)                # (BY, BX), 4 warps
STAR_BLOCK = (8, 64)                   # (BY, BX) of one z-plane, 4 warps
TRANSPOSE_BLOCK = (64, 64)             # (BM, BN), 4 warps
GEMM_BLOCK = (128, 128, 64)            # (BM, BN, BK), 8 warps, 3 stages
NUM_WARPS = 4                          # every launch but the GEMM's
GEMM_NUM_WARPS, GEMM_NUM_STAGES = 8, 3


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_pow2(what: str, *blocks) -> None:
    for b in blocks:
        if b <= 0 or b & (b - 1):
            raise ValueError(f"{what}: block sizes {blocks} must be powers of "
                             f"two (Triton's tl.arange)")


def _launches(x, name: str) -> bool:
    """True where the launcher launches (CUDA or the tracer's meta); on a
    CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        LAUNCHES[name] += 1
    return True


# ---------------------------------------------------------------------------
# scale_shift
# ---------------------------------------------------------------------------
@triton.jit
def scale_shift_kernel(x_ptr, out_ptr, Y, X, stride_y, scale, shift,
                       BY: tl.constexpr, BX: tl.constexpr):
    rows = tl.program_id(0) * BY + tl.arange(0, BY)[:, None]
    cols = tl.program_id(1) * BX + tl.arange(0, BX)[None, :]
    mask = (rows < Y) & (cols < X)
    offs = rows * stride_y + cols
    x = tl.load(x_ptr + offs, mask=mask)
    tl.store(out_ptr + offs, x * scale + shift, mask=mask)


def scale_shift_ref(x, scale: float = 2.0, shift: float = 1.0):
    return x * scale + shift


def scale_shift(scale: float = 2.0, shift: float = 1.0,
                block=SCALE_SHIFT_BLOCK):
    """The launcher of ``out = x * scale + shift`` on a contiguous (Y, X)
    ``x`` at (BY, BX) tiles."""
    by, bx = block
    _check_pow2("scale_shift", by, bx)

    def call(x):
        if not _launches(x, "scale_shift"):
            return scale_shift_ref(x, scale, shift)
        out = x.new_empty(x.shape)
        Y, X = x.shape
        grid = (triton.cdiv(Y, by), triton.cdiv(X, bx))
        scale_shift_kernel[grid](x, out, Y, X, x.stride(0), scale, shift,
                                 BY=by, BX=bx, num_warps=NUM_WARPS)
        return out

    return call


# ---------------------------------------------------------------------------
# the weighted 5-point Jacobi sweep
# ---------------------------------------------------------------------------
@triton.jit
def jacobi5_kernel(src_ptr, dst_ptr, Y, X, stride_s, stride_d, wc, wn,
                   BY: tl.constexpr, BX: tl.constexpr):
    rows = tl.program_id(0) * BY + tl.arange(0, BY)[:, None]
    cols = tl.program_id(1) * BX + tl.arange(0, BX)[None, :]
    mask = (rows < Y) & (cols < X)
    c = src_ptr + (rows + 1) * stride_s + (cols + 1)
    centre = tl.load(c, mask=mask)
    up = tl.load(c - stride_s, mask=mask)
    down = tl.load(c + stride_s, mask=mask)
    left = tl.load(c - 1, mask=mask)
    right = tl.load(c + 1, mask=mask)
    out = wc * centre + wn * (up + down + left + right)
    tl.store(dst_ptr + rows * stride_d + cols, out, mask=mask)


def jacobi5_ref(src_padded, weights=(0.5, 0.125)):
    """One sweep on the halo-1 padded (Y+2, X+2) source; returns (Y, X),
    summed in the kernel's order."""
    wc, wn = (float(w) for w in weights)
    p = src_padded
    return wc * p[1:-1, 1:-1] + wn * (p[:-2, 1:-1] + p[2:, 1:-1]
                                      + p[1:-1, :-2] + p[1:-1, 2:])


def jacobi5(weights=(0.5, 0.125), block=JACOBI_BLOCK):
    """The launcher of one Jacobi sweep on a contiguous padded (Y+2, X+2)
    ``src``; returns the (Y, X) ``dst``."""
    by, bx = block
    _check_pow2("jacobi5", by, bx)
    wc, wn = (float(w) for w in weights)

    def call(src):
        if not _launches(src, "jacobi5"):
            return jacobi5_ref(src, weights)
        Y, X = src.shape[0] - 2, src.shape[1] - 2
        dst = src.new_empty((Y, X))
        grid = (triton.cdiv(Y, by), triton.cdiv(X, bx))
        jacobi5_kernel[grid](src, dst, Y, X, src.stride(0), dst.stride(0),
                             wc, wn, BY=by, BX=bx, num_warps=NUM_WARPS)
        return dst

    return call


# ---------------------------------------------------------------------------
# the range-r 3D star stencil, one point a lane
# ---------------------------------------------------------------------------
@triton.jit
def _star_axis(c, mask, stride, R: tl.constexpr, w1, w2, w3, w4):
    """The 2R taps of one axis, nearest first, minus before plus."""
    acc = w1 * (tl.load(c - stride, mask=mask) + tl.load(c + stride, mask=mask))
    if R >= 2:
        acc += w2 * (tl.load(c - 2 * stride, mask=mask)
                     + tl.load(c + 2 * stride, mask=mask))
    if R >= 3:
        acc += w3 * (tl.load(c - 3 * stride, mask=mask)
                     + tl.load(c + 3 * stride, mask=mask))
    if R >= 4:
        acc += w4 * (tl.load(c - 4 * stride, mask=mask)
                     + tl.load(c + 4 * stride, mask=mask))
    return acc


@triton.jit
def star_kernel(src_ptr, dst_ptr, Y, X, s_z, s_y, d_z, d_y,
                w0, w1, w2, w3, w4,
                R: tl.constexpr, BY: tl.constexpr, BX: tl.constexpr):
    z = tl.program_id(0)
    rows = tl.program_id(1) * BY + tl.arange(0, BY)[:, None]
    cols = tl.program_id(2) * BX + tl.arange(0, BX)[None, :]
    mask = (rows < Y) & (cols < X)
    c = src_ptr + (z + R) * s_z + (rows + R) * s_y + (cols + R)
    acc = w0 * tl.load(c, mask=mask)
    acc += _star_axis(c, mask, s_z, R, w1, w2, w3, w4)
    acc += _star_axis(c, mask, s_y, R, w1, w2, w3, w4)
    acc += _star_axis(c, mask, 1, R, w1, w2, w3, w4)
    tl.store(dst_ptr + z * d_z + rows * d_y + cols, acc, mask=mask)


STAR_MAX_R = 4
# w0, then one a distance; exact in fp32, the type Triton gives a float argument
STAR_WEIGHTS = (0.5, 0.0625, 0.03125, 0.015625, 0.0078125)


def star_ref(src_padded, r: int, weights=STAR_WEIGHTS):
    """The star on the halo-r padded (Z+2r, Y+2r, X+2r) source; returns
    (Z, Y, X), summed in the kernel's order."""
    Z, Y, X = (n - 2 * r for n in src_padded.shape)

    def at(dz, dy, dx):
        return src_padded[r + dz:r + dz + Z, r + dy:r + dy + Y,
                          r + dx:r + dx + X]

    acc = weights[0] * at(0, 0, 0)
    for axis in range(3):
        part = None
        for o in range(1, r + 1):
            minus, plus = [0, 0, 0], [0, 0, 0]
            minus[axis], plus[axis] = -o, o
            term = weights[o] * (at(*minus) + at(*plus))
            part = term if part is None else part + term
        acc = acc + part
    return acc


def star(r: int, weights=STAR_WEIGHTS, block=STAR_BLOCK):
    """The launcher of the range-r star (1 <= r <= 4) on a contiguous padded
    (Z+2r, Y+2r, X+2r) ``src``; returns the (Z, Y, X) ``dst``."""
    if not 1 <= r <= STAR_MAX_R:
        raise ValueError(f"star: r {r} outside 1..{STAR_MAX_R}")
    by, bx = block
    _check_pow2("star", by, bx)
    w = [float(v) for v in weights] + [0.0] * (STAR_MAX_R + 1 - len(weights))

    def call(src):
        if not _launches(src, "star"):
            return star_ref(src, r, weights)
        Z, Y, X = (n - 2 * r for n in src.shape)
        dst = src.new_empty((Z, Y, X))
        grid = (Z, triton.cdiv(Y, by), triton.cdiv(X, bx))
        star_kernel[grid](src, dst, Y, X, src.stride(0), src.stride(1),
                          dst.stride(0), dst.stride(1), *w[:STAR_MAX_R + 1],
                          R=r, BY=by, BX=bx, num_warps=NUM_WARPS)
        return dst

    return call


# ---------------------------------------------------------------------------
# the transpose
# ---------------------------------------------------------------------------
@triton.jit
def transpose_kernel(x_ptr, xt_ptr, M, N, stride_x, stride_t,
                     BM: tl.constexpr, BN: tl.constexpr):
    rows = tl.program_id(0) * BM + tl.arange(0, BM)[:, None]
    cols = tl.program_id(1) * BN + tl.arange(0, BN)[None, :]
    mask = (rows < M) & (cols < N)
    x = tl.load(x_ptr + rows * stride_x + cols, mask=mask)
    tl.store(xt_ptr + cols * stride_t + rows, x, mask=mask)


def transpose_ref(x):
    return x.t().contiguous()


def transpose(block=TRANSPOSE_BLOCK):
    """The launcher of the transpose of a contiguous (M, N) ``x``; returns
    the (N, M) ``xt``."""
    bm, bn = block
    _check_pow2("transpose", bm, bn)

    def call(x):
        if not _launches(x, "transpose"):
            return transpose_ref(x)
        M, N = x.shape
        xt = x.new_empty((N, M))
        grid = (triton.cdiv(M, bm), triton.cdiv(N, bn))
        transpose_kernel[grid](x, xt, M, N, x.stride(0), xt.stride(0),
                               BM=bm, BN=bn, num_warps=NUM_WARPS)
        return xt

    return call


# ---------------------------------------------------------------------------
# the blocked GEMM
# ---------------------------------------------------------------------------
@triton.jit
def gemm_kernel(a_ptr, b_ptr, c_ptr, K, s_am, s_ak, s_bk, s_bn, s_cm, s_cn,
                BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
    offs_m = tl.program_id(0) * BM + tl.arange(0, BM)
    offs_n = tl.program_id(1) * BN + tl.arange(0, BN)
    offs_k = tl.arange(0, BK)
    acc = tl.zeros((BM, BN), dtype=tl.float32)
    for k in range(0, K, BK):
        a = tl.load(a_ptr + offs_m[:, None] * s_am + (k + offs_k)[None, :] * s_ak)
        b = tl.load(b_ptr + (k + offs_k)[:, None] * s_bk + offs_n[None, :] * s_bn)
        acc += tl.dot(a, b)
    c = acc.to(c_ptr.dtype.element_ty)
    tl.store(c_ptr + offs_m[:, None] * s_cm + offs_n[None, :] * s_cn, c)


def gemm_ref(a, b):
    """The product in fp32, rounded once to the operands' dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def gemm(block=GEMM_BLOCK):
    """The launcher of ``a @ b`` for contiguous (M, K) ``a`` and (K, N)
    ``b`` whose dims the tiles divide; returns the (M, N) product in the
    operands' dtype, accumulated in fp32."""
    bm, bn, bk = block
    _check_pow2("gemm", bm, bn, bk)

    def call(a, b):
        if not _launches(a, "gemm"):
            return gemm_ref(a, b)
        (M, K), N = a.shape, b.shape[1]
        if M % bm or N % bn or K % bk:
            raise ValueError(f"gemm: tiles {block} do not divide ({M}, {K}, {N})")
        c = a.new_empty((M, N))
        gemm_kernel[(M // bm, N // bn)](
            a, b, c, K, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            c.stride(0), c.stride(1), BM=bm, BN=bn, BK=bk,
            num_warps=GEMM_NUM_WARPS, num_stages=GEMM_NUM_STAGES)
        return c

    return call


# ---------------------------------------------------------------------------
# the specs each fixture must trace to
# ---------------------------------------------------------------------------
def traced(kind: str, shape, dtype, **tiles):
    """``(launcher, args, trace kwargs, CostModel, rename)`` of one fixture
    at ``shape`` (scale_shift, jacobi5: (Y, X); star: (r, (Z, Y, X));
    transpose: (M, N); gemm: (M, K, N))."""
    from .lower import CostModel
    from .trace import arg

    if kind == "scale_shift":
        return (scale_shift(**tiles), [arg("x", shape, dtype)],
                dict(name="scale_shift"), None, None)
    if kind == "jacobi5":
        Y, X = shape
        return (jacobi5(**tiles), [arg("src", (Y + 2, X + 2), dtype)],
                dict(name="stencil2d5pt", out_names=("dst",)),
                CostModel(flops_per_point=5.0), None)
    if kind == "star":
        r, (Z, Y, X) = shape
        return (star(r, **tiles),
                [arg("src", (Z + 2 * r, Y + 2 * r, X + 2 * r), dtype)],
                dict(name=f"star3d_r{r}", out_names=("dst",)),
                CostModel(flops_per_point=float(6 * r + 1)), None)
    if kind == "transpose":
        return (transpose(**tiles), [arg("x", shape, dtype)],
                dict(name="transpose_pad", out_names=("xt",)),
                CostModel(flops_per_point=0.0), None)
    if kind == "gemm":
        M, K, N = shape
        return (gemm(**tiles), [arg("a", (M, K), dtype), arg("b", (K, N), dtype)],
                dict(name=f"gemm_{M}x{K}x{N}", out_names=("o",)),
                CostModel(flops_per_point=2.0, work_unit="MAC"),
                {"a": "A", "b": "B", "o": "C"})
    raise KeyError(f"no fixture {kind!r}")


def traced_gpu_spec(kind: str, shape, dtype, **tiles):
    """The fixture's GPU lowering, traced from its launcher."""
    from .lower import lower_gpu
    from .trace import trace_kernel

    call, args, kw, costs, rename = traced(kind, shape, dtype, **tiles)
    return lower_gpu(trace_kernel(call, args, trace_body=True, **kw), costs,
                     name=kw["name"], rename=rename)


def hand_spec(kind: str, shape, elem_bytes: int):
    """The ``core.specs`` spec the fixture's GPU lowering must equal."""
    from repro_torch.core import specs

    if kind == "jacobi5":
        return specs.stencil_2d5pt(tuple(shape), elem_bytes)
    if kind == "star":
        r, domain = shape
        return specs.star_stencil_3d(r, tuple(domain), elem_bytes)
    if kind == "transpose":
        return specs.transpose_pad(tuple(shape), elem_bytes)
    if kind == "gemm":
        return specs.matmul_naive(*shape, elem_bytes)
    raise KeyError(f"no hand spec for {kind!r}")
