// Hand-written Hopper (sm_90a) kernels for the 2D transpose
//
//   xt[n, m] = x[m, n],   x (M, N) and xt (N, M), both contiguous.
//
// The kernels only move data, so they are templated on an unsigned integer
// of the element's width (1, 2, 4 or 8 bytes) and serve every dtype of that
// width bit for bit.
//
// transpose_pointwise
//   The kernel the analytical GPU model prices (core.specs.transpose_pad):
//   over the output domain (N, M), read as (1, N, M), one thread per
//   (point x fold iteration) with exactly the
//   repro_torch/core/gridwalk.py:block_points mapping — thread
//   (tx,ty,tz) of block (bx,by,bz) computes
//   (bz*ez + tz*fz + jz, by*ey + ty*fy + jy, bx*ex + tx*fx + jx), fold loops
//   jz outer .. jx inner, guarded at the domain edge.  Point (y, x) loads
//   x[x, y] and stores xt[y, x].  The domain has depth 1, so in a launch with
//   bz > 1 only the tz = 0 threads have points; the GPU model does not price
//   the idle ones (the reference's model, reproduced as it is).
//   Bound on the H100: DRAM bytes (each element read once and written once,
//   no arithmetic).  Stores along x are coalesced, loads along x stride by
//   N elements, and the ranked launch decides how much of each loaded line
//   L1 and L2 keep for the neighbouring threads in y: a load takes 8 or 16
//   bytes of a 32-byte sector, and the next y-block takes the rest.  That
//   priced stream is fixed: the points of each thread, one load and one
//   store a point, at the same addresses.  The design changes only what
//   lies around it:
//   * compile-time folds for those of the 168 priced launches (fx = 1,
//     fy = 1 or 2; fz is 1 or 2, and on the depth-1 domain only a thread
//     with z0 = 0 has points), with one generic instantiation for any other
//     launch, so a thread's loads are all issued before its first store;
//   * loads through the read-only path (ld.global.nc) and streaming stores
//     (st.global.cs, evict first), so the output, written once, leaves L2
//     to the input sectors that the neighbouring y-blocks still read.
//   Offsets are 64-bit, so every size takes the one path.  The ablation
//   (kernels/transpose_pad/ablate.py) finds the whole gain in the
//   compile-time folds: 32-bit offsets and plain loads and stores each
//   measured within 1 % of this build at the ranked launches (PERF.md), so
//   neither has a path of its own.  A thread's two adjacent loads at fy = 2
//   merged into one vector load (same bytes, same sectors, so the same
//   priced stream) measured no gain and were left out.
//
// transpose_tiled
//   Replaces the TPU kernel repro/kernels/transpose_pad/kernel.py:
//   make_transpose(M, N, bm, bn) (grid (M/bm, N/bn); a (bm, bn) tile into
//   VMEM, its transpose written as the (bn, bm) tile at (j, i)).  One CTA per
//   (bm, bn) block of that grid; it walks the block in 32 x 32 sub-tiles,
//   each read with coalesced rows into a shared 32 x 33 tile and written
//   back as coalesced rows of the transpose.  The padded column puts the 32
//   elements of a tile column in 32 different banks, and the sub-tiles let
//   every (bm, bn) of the TPU generator's space (8..512) fit a block's shared
//   memory.  Bound on the H100: DRAM bytes.  The edges are masked, so the
//   operand needs no padding to tile multiples.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;      // sub-tile side
constexpr int kTileRows = 8;   // threads of a CTA along the sub-tile's rows

// the design switch that kernels/transpose_pad/ablate.py flips
constexpr bool kFoldInstances = true;  // compile-time folds for the priced launches

// FX, FY > 0: the folds are compile-time constants (fx = FX, fy = FY) and
// every point's load is issued before the first store; FX = FY = 0 takes
// them from the arguments.
template <typename T, int FX, int FY>
__global__ void __launch_bounds__(1024)
transpose_pointwise_kernel(const T* __restrict__ x, T* __restrict__ xt, int M,
                           int N, int fx_arg, int fy_arg, int fz) {
  const int fx = FX > 0 ? FX : fx_arg;
  const int fy = FY > 0 ? FY : fy_arg;
  // the domain (1, N, M) has one plane: a thread has points only if its
  // first z (fold jz = 0) is plane 0
  if (blockIdx.z * (blockDim.z * fz) + threadIdx.z * fz != 0) return;
  const int x0 = blockIdx.x * (blockDim.x * fx) + threadIdx.x * fx;
  const int y0 = blockIdx.y * (blockDim.y * fy) + threadIdx.y * fy;
  if constexpr (FX > 0) {
    T v[FY][FX];
#pragma unroll
    for (int jy = 0; jy < FY; ++jy)
#pragma unroll
      for (int jx = 0; jx < FX; ++jx)
        if (y0 + jy < N && x0 + jx < M) v[jy][jx] = __ldg(x + (int64_t)(x0 + jx) * N + (y0 + jy));
#pragma unroll
    for (int jy = 0; jy < FY; ++jy)
#pragma unroll
      for (int jx = 0; jx < FX; ++jx)
        if (y0 + jy < N && x0 + jx < M) __stcs(xt + (int64_t)(y0 + jy) * M + (x0 + jx), v[jy][jx]);
  } else {
    for (int jy = 0; jy < fy; ++jy) {
      const int y = y0 + jy;
      if (y >= N) break;
      for (int jx = 0; jx < fx; ++jx) {
        const int m = x0 + jx;
        if (m >= M) break;
        __stcs(xt + (int64_t)y * M + m, __ldg(x + (int64_t)m * N + y));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
transpose_tiled_kernel(const T* __restrict__ x, T* __restrict__ xt, int M,
                       int N, int bm, int bn) {
  __shared__ T tile[kTile][kTile + 1];
  const int m0 = blockIdx.y * bm;
  const int n0 = blockIdx.x * bn;
  const int m_end = min(m0 + bm, M);
  const int n_end = min(n0 + bn, N);
  for (int sm = m0; sm < m_end; sm += kTile) {
    for (int sn = n0; sn < n_end; sn += kTile) {
      const int n = sn + threadIdx.x;
      for (int r = threadIdx.y; r < kTile; r += kTileRows) {
        const int m = sm + r;
        if (m < m_end && n < n_end) tile[r][threadIdx.x] = x[(int64_t)m * N + n];
      }
      __syncthreads();
      const int m = sm + threadIdx.x;
      for (int r = threadIdx.y; r < kTile; r += kTileRows) {
        const int nn = sn + r;
        if (nn < n_end && m < m_end) xt[(int64_t)nn * M + m] = tile[threadIdx.x][r];
      }
      __syncthreads();
    }
  }
}

template <typename T, int FX, int FY>
int go_pointwise(const void* x, void* xt, int M, int N, int bx, int by, int bz, int fx, int fy,
                 int fz, cudaStream_t stream) {
  const int ex = bx * fx, ey = by * fy, ez = bz * fz;
  const dim3 grid((M + ex - 1) / ex, (N + ey - 1) / ey, (1 + ez - 1) / ez);
  transpose_pointwise_kernel<T, FX, FY><<<grid, dim3(bx, by, bz), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xt), M, N, fx, fy, fz);
  return (int)cudaGetLastError();
}

// the folds of the priced launches (fx 1, fy 1 or 2) unrolled, any other the
// generic kernel
template <typename T>
int launch_pointwise(const void* x, void* xt, int M, int N, int bx, int by, int bz, int fx,
                     int fy, int fz, cudaStream_t s) {
  if (kFoldInstances && fx == 1 && fy == 1)
    return go_pointwise<T, 1, 1>(x, xt, M, N, bx, by, bz, fx, fy, fz, s);
  if (kFoldInstances && fx == 1 && fy == 2)
    return go_pointwise<T, 1, 2>(x, xt, M, N, bx, by, bz, fx, fy, fz, s);
  return go_pointwise<T, 0, 0>(x, xt, M, N, bx, by, bz, fx, fy, fz, s);
}

template <typename T>
int launch_tiled(const void* x, void* xt, int M, int N, int bm, int bn,
                 cudaStream_t stream) {
  const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm, 1);
  transpose_tiled_kernel<T><<<grid, dim3(kTile, kTileRows, 1), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xt), M, N, bm, bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// elem_bytes selects the element width (1, 2, 4 or 8); any other value
// returns cudaErrorInvalidValue without launching.
int transpose_pointwise_launch(int elem_bytes, const void* x, void* xt, int M,
                               int N, int bx, int by, int bz, int fx, int fy,
                               int fz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_pointwise<uint8_t>(x, xt, M, N, bx, by, bz, fx, fy, fz, s);
    case 2: return launch_pointwise<uint16_t>(x, xt, M, N, bx, by, bz, fx, fy, fz, s);
    case 4: return launch_pointwise<uint32_t>(x, xt, M, N, bx, by, bz, fx, fy, fz, s);
    case 8: return launch_pointwise<unsigned long long>(x, xt, M, N, bx, by, bz, fx, fy, fz, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int transpose_tiled_launch(int elem_bytes, const void* x, void* xt, int M,
                           int N, int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_tiled<uint8_t>(x, xt, M, N, bm, bn, s);
    case 2: return launch_tiled<uint16_t>(x, xt, M, N, bm, bn, s);
    case 4: return launch_tiled<uint32_t>(x, xt, M, N, bm, bn, s);
    case 8: return launch_tiled<uint64_t>(x, xt, M, N, bm, bn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* transpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
