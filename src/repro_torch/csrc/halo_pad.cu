// Hand-written Hopper (sm_90a) kernel for the zero halo of the entry points
// (kernels/stencil3d25/ops.py:star_stencil, kernels/lbm_d3q15/ops.py:lbm_step)
//
//   dst[f, z, y, x] = src[f, z-h, y-h, x-h]   where every index lies in the field,
//                   = 0                        elsewhere (the halo),
//
// src (F, Z, Y, X) and dst (F, Z+2h, Y+2h, X+2h), both contiguous, in float
// or double; F is the product of any leading dims, so the LBM's 15 PDFs go in
// one launch.
//
// It replaces no TPU kernel: it stands in for the jnp.pad calls in
// repro/kernels/stencil3d25/ops.py and repro/kernels/lbm_d3q15/ops.py, which
// the reference leaves to XLA.
//
// Bound on the H100: DRAM bytes, one read of src and one write of dst; it
// computes nothing.  torch.nn.functional.pad takes two passes, a zero fill of
// all of dst and then a strided copy into its interior, so it writes the
// interior twice.  Here each element of dst is written exactly once, the
// interior from src and the halo as zero, and each element of src is read
// once:
//   * one warp a padded row, eight rows a CTA, a grid of every row.  A row
//     outside src in y or z is stored as zeros; any other row in vectors of
//     V elements, the widest of 16, 8 and 4 bytes that the padded rows and
//     dst's address take (kernels/halo_pad.py:pad_vector), each lane loading
//     kUnroll vectors before it stores them, so a padded row of up to
//     32 * kUnroll vectors (the LBM's 258 doubles) takes one pass;
//   * the loads are single elements, each checked against the row: a warp's
//     loads still cover whole 32-byte sectors, and vector loads where h and
//     X allow them (the stencil's h = 4) measured level with these, alone
//     and in the stencil's loop, so one load path serves every h.
// On an H100 at the benchmark's fields the kernel alone moves 2.87-2.98 TB/s
// (86-89 % of the bound), where a contiguous copy of the same bytes moves
// 2.97-3.05.  A grid of a warp a row measured 4-10 % faster than a
// persistent grid of CTAs walking the rows.  A TMA version (a CTA a box of
// padded rows, loaded at coordinates shifted by -h so that TMA's zero fill
// of what lies outside src is the halo, then stored) ran within 2 % of this
// kernel alone, either way, and 0.06-0.12 % slower in the stencil's loop;
// it takes no 8-byte halo (a box starts on a 16-byte column), so this one
// kernel serves every field (PERF.md).
//
// The launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows a CTA
constexpr int kUnroll = 8;     // vectors a lane loads before it stores them

struct PadArgs {
  int fields, Z, Y, X, h;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// elements x .. x+V-1 of a source row of X elements (x may be negative);
// those outside the row are zero
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* __restrict__ row, int x, int X) {
  Vec<T, V> w;
#pragma unroll
  for (int k = 0; k < V; ++k) w.v[k] = (unsigned)(x + k) < (unsigned)X ? row[x + k] : T(0);
  return w;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
halo_pad_kernel(const T* __restrict__ src, T* __restrict__ dst, const PadArgs a) {
  using W = Vec<T, V>;
  const int Xp = a.X + 2 * a.h, Yp = a.Y + 2 * a.h, Zp = a.Z + 2 * a.h;
  const int nvec = Xp / V;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= (int64_t)a.fields * Zp * Yp) return;
  const int lane = threadIdx.x & 31;
  const int64_t plane = row / Yp, f = plane / Zp;
  const int y = (int)(row - plane * Yp) - a.h, z = (int)(plane - f * Zp) - a.h;
  W* out = reinterpret_cast<W*>(dst + row * Xp);
  if ((unsigned)y >= (unsigned)a.Y || (unsigned)z >= (unsigned)a.Z) {
    W zero;
#pragma unroll
    for (int k = 0; k < V; ++k) zero.v[k] = T(0);
    for (int j = lane; j < nvec; j += 32) out[j] = zero;
    return;
  }
  const T* in = src + ((f * a.Z + z) * a.Y + y) * a.X;
  for (int j0 = lane; j0 < nvec; j0 += 32 * kUnroll) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u;
      if (j < nvec) v[u] = load_vec<T, V>(in, j * V - a.h, a.X);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u;
      if (j < nvec) out[j] = v[u];
    }
  }
}

template <typename T, int V>
int launch(const void* src, void* dst, const PadArgs& a, cudaStream_t stream) {
  const int64_t rows = (int64_t)a.fields * (a.Z + 2 * a.h) * (a.Y + 2 * a.h);
  const int64_t ctas = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (ctas >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  halo_pad_kernel<T, V><<<(unsigned)ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* src, void* dst, const PadArgs& a, int vec, cudaStream_t s) {
  if (vec == 1) return launch<T, 1>(src, dst, a, s);
  if (vec == 2) return launch<T, 2>(src, dst, a, s);
  if constexpr (sizeof(T) == 4)
    if (vec == 4) return launch<T, 4>(src, dst, a, s);
  return (int)cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

extern "C" {

// elem_bytes selects float (4) or double (8); the padded rows are stored in
// vectors of `vec` elements.  What would let the kernel read or write outside
// its buffers, or misalign a vector, returns cudaErrorInvalidValue without
// launching.
int halo_pad_launch(int elem_bytes, const void* src, void* dst, int fields, int Z, int Y, int X,
                    int h, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((elem_bytes != 4 && elem_bytes != 8) || fields < 1 || Z < 1 || Y < 1 || X < 1 || h < 0 ||
      vec < 1 || (X + 2 * h) % vec || !aligned(dst, vec * elem_bytes))
    return (int)cudaErrorInvalidValue;
  const PadArgs a{fields, Z, Y, X, h};
  return elem_bytes == 8 ? dispatch<double>(src, dst, a, vec, s)
                         : dispatch<float>(src, dst, a, vec, s);
}

const char* halo_pad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
