// Hand-written Hopper (sm_90a) kernels for the range-r 3D star stencil
// (paper §5.2; r = 4 is the 25-point stencil), in float and double.
//
//   dst[z,y,x] = w[0]*src[z,y,x]
//              + sum over axis (z, y, x), o = 1..r, s = -o, +o of w[k]*src[.. +s ..]
//
// `src` is the (Z+2r, Y+2r, X+2r) halo-padded field, `dst` is (Z, Y, X), both
// contiguous; `w` holds the 6r+1 weights in the order of ref.py: centre, then
// (z,-1), (z,+1), ..., (z,-r), (z,+r), then the same for y, then for x.  Taps
// are summed in exactly that order (acc = acc + w*v), so the only difference
// to the plain version is FMA contraction.
//
// star_pointwise
//   Replaces the TPU kernel repro/kernels/stencil3d25/kernel.py:make_replane
//   (grid Z, 2r+1 padded planes streamed per output plane).  It is the kernel
//   the analytical GPU model prices: one thread per (point x fold iteration)
//   with exactly the repro_torch/core/gridwalk.py:block_points mapping —
//   blockDim = (bx, by, bz), gridDim = LaunchConfig.grid_for(domain), thread
//   (tx,ty,tz) of block (bx,by,bz) computes
//   (bz*ez + tz*fz + jz, by*ey + ty*fy + jy, bx*ex + tx*fx + jx), fold loops
//   jz outer .. jx inner, guarded at the domain edge.
//   Bound on the H100: DRAM bytes (each padded input element read once, each
//   output written once; 6r+1 multiply-adds per point are far below the fp64
//   rate).  Design: the 2r+1 re-reads of each element along z, y and x are
//   left to L1 and L2, which is what the estimator models, so the launch
//   (block x folding) that the ranking picks decides how much of the
//   re-read traffic the caches absorb.  What the kernel itself must do is
//   keep enough loads in flight: r = 1..4 are compiled with the tap loops
//   unrolled (any other r runs a generic instantiation), so all 6r+1 loads
//   of a point issue before the first multiply-add waits, and the weights
//   are staged once per block in shared memory.
//
// star_zmarch
//   Replaces make_ring (grid Z+2r, one padded plane loaded per step into a
//   (2r+1)-plane VMEM ring) and make_ytile_ring(ty) (the same ring over ty-row
//   tiles).  Blocks run in parallel on Hopper, so the TPU's sequential grid
//   axis becomes a loop inside the block: each CTA owns a TY x TX output tile
//   and marches over the Z+2r padded planes.  A shared-memory ring of 2r+1
//   planes of (TY+2r) x (TX+2r) elements is filled by coalesced loads, with
//   __syncthreads between steps; from step t >= 2r it writes output plane
//   t-2r.  Bound on the H100: DRAM bytes.  Design: every padded element is
//   loaded from device memory once per tile that covers it (a halo overhead
//   of (TY+2r)(TX+2r)/(TY*TX)), and all 6r+1 taps then come from shared
//   memory.  While step t computes, each thread already holds its share of
//   plane t+1 in registers (kPrefetch elements), so the load latency of a
//   plane overlaps the previous plane's arithmetic instead of stalling
//   between the two barriers.  The ring is dynamic shared memory, opted in
//   above 48 KB with cudaFuncSetAttribute; its capacity (232,448 B per
//   block) takes the place of the TPU's VMEM layer condition.  The tile edge
//   is masked here, so the input needs no extra y-padding.  cp.async / TMA
//   staging is later work.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Ring elements each thread stages per plane (registers); the launcher
// refuses tiles whose halo plane exceeds kPrefetch * blockDim.x.
constexpr int kPrefetch = 8;

// Copy the 6r+1 weights into shared memory: every tap then reads them with
// a broadcast shared load instead of a global load per thread.
template <typename T>
__device__ __forceinline__ void stage_weights(T* ws, const T* __restrict__ w,
                                              int n, int tid, int nthreads) {
  for (int k = tid; k < n; k += nthreads) ws[k] = w[k];
  __syncthreads();
}

// RT > 0: the range r = RT is a compile-time constant and every tap loop
// unrolls, so all 6r+1 loads of a point can be in flight at once; RT == 0
// takes r from the runtime argument (any r).
template <typename T, int RT>
__global__ void __launch_bounds__(1024)
star_pointwise_kernel(const T* __restrict__ src, T* __restrict__ dst,
                      const T* __restrict__ w, int r_arg, int Z, int Y, int X,
                      int fx, int fy, int fz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  const int r = RT > 0 ? RT : r_arg;
  const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  stage_weights(ws, w, 6 * r + 1, tid, blockDim.x * blockDim.y * blockDim.z);
  const int64_t Xp = X + 2 * r;
  const int64_t Yp = Y + 2 * r;
  const int64_t sy = Xp;
  const int64_t sz = Yp * Xp;
  const int x0 = blockIdx.x * (blockDim.x * fx) + threadIdx.x * fx;
  const int y0 = blockIdx.y * (blockDim.y * fy) + threadIdx.y * fy;
  const int z0 = blockIdx.z * (blockDim.z * fz) + threadIdx.z * fz;
  for (int jz = 0; jz < fz; ++jz) {
    const int z = z0 + jz;
    if (z >= Z) break;
    for (int jy = 0; jy < fy; ++jy) {
      const int y = y0 + jy;
      if (y >= Y) break;
      for (int jx = 0; jx < fx; ++jx) {
        const int x = x0 + jx;
        if (x >= X) break;
        const T* c = src + ((int64_t)(z + r) * Yp + (y + r)) * Xp + (x + r);
        T acc = ws[0] * c[0];
#pragma unroll
        for (int o = 1; o <= r; ++o) {
          acc = acc + ws[2 * o - 1] * c[-o * sz];
          acc = acc + ws[2 * o] * c[o * sz];
        }
#pragma unroll
        for (int o = 1; o <= r; ++o) {
          acc = acc + ws[2 * r + 2 * o - 1] * c[-o * sy];
          acc = acc + ws[2 * r + 2 * o] * c[o * sy];
        }
#pragma unroll
        for (int o = 1; o <= r; ++o) {
          acc = acc + ws[4 * r + 2 * o - 1] * c[-o];
          acc = acc + ws[4 * r + 2 * o] * c[o];
        }
        dst[((int64_t)z * Y + y) * X + x] = acc;
      }
    }
  }
}

// Load this thread's share of padded plane t's halo tile into registers.
template <typename T>
__device__ __forceinline__ void fetch_plane(T (&pre)[kPrefetch],
                                            const T* __restrict__ src, int t,
                                            int Yp, int Xp, int y0, int x0,
                                            int hx, int plane) {
  const T* src_plane = src + (int64_t)t * Yp * Xp;
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < plane) {
      const int ly = i / hx;
      const int gy = y0 + ly;
      const int gx = x0 + (i - ly * hx);
      pre[j] = (gy < Yp && gx < Xp) ? src_plane[(int64_t)gy * Xp + gx] : T(0);
    }
  }
}

template <typename T, int RT>
__global__ void __launch_bounds__(1024)
star_zmarch_kernel(const T* __restrict__ src, T* __restrict__ dst,
                   const T* __restrict__ w, int r_arg, int Z, int Y, int X,
                   int ty, int tx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r = RT > 0 ? RT : r_arg;
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* ring = ws + 6 * r + 1;
  stage_weights(ws, w, 6 * r + 1, threadIdx.x, blockDim.x);
  const int nring = 2 * r + 1;
  const int Xp = X + 2 * r;
  const int Yp = Y + 2 * r;
  const int Zp = Z + 2 * r;
  const int hx = tx + 2 * r;  // halo tile row length
  const int plane = (ty + 2 * r) * hx;
  // tile origin: output (y0, x0) is padded (y0 + r, x0 + r), so the halo
  // tile starts at padded (y0, x0)
  const int y0 = blockIdx.y * ty;
  const int x0 = blockIdx.x * tx;
  T pre[kPrefetch];
  fetch_plane(pre, src, 0, Yp, Xp, y0, x0, hx, plane);
  for (int t = 0; t < Zp; ++t) {
    // step t: padded plane t into ring slot t mod (2r+1); that slot held
    // plane t-2r-1, whose last reader was step t-1 (barrier at loop end)
    T* slot = ring + (t % nring) * plane;
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < plane) slot[i] = pre[j];
    }
    __syncthreads();
    // plane t+1 is loaded into registers while step t computes
    if (t + 1 < Zp) fetch_plane(pre, src, t + 1, Yp, Xp, y0, x0, hx, plane);
    if (t >= 2 * r) {
      const int z = t - 2 * r;
      const T* cpl = ring + ((t - r) % nring) * plane;
      for (int i = threadIdx.x; i < ty * tx; i += blockDim.x) {
        const int ly = i / tx;
        const int lx = i - ly * tx;
        const int y = y0 + ly;
        const int x = x0 + lx;
        if (y >= Y || x >= X) continue;
        const int ci = (ly + r) * hx + (lx + r);
        T acc = ws[0] * cpl[ci];
#pragma unroll
        for (int o = 1; o <= r; ++o) {
          acc = acc + ws[2 * o - 1] * ring[((t - r - o) % nring) * plane + ci];
          acc = acc + ws[2 * o] * ring[((t - r + o) % nring) * plane + ci];
        }
#pragma unroll
        for (int o = 1; o <= r; ++o) {
          acc = acc + ws[2 * r + 2 * o - 1] * cpl[ci - o * hx];
          acc = acc + ws[2 * r + 2 * o] * cpl[ci + o * hx];
        }
#pragma unroll
        for (int o = 1; o <= r; ++o) {
          acc = acc + ws[4 * r + 2 * o - 1] * cpl[ci - o];
          acc = acc + ws[4 * r + 2 * o] * cpl[ci + o];
        }
        dst[((int64_t)z * Y + y) * X + x] = acc;
      }
    }
    __syncthreads();
  }
}

template <typename T, int RT>
int launch_pointwise(const void* src, void* dst, const void* w, int r, int Z,
                     int Y, int X, int bx, int by, int bz, int fx, int fy,
                     int fz, cudaStream_t stream) {
  const int ex = bx * fx, ey = by * fy, ez = bz * fz;
  const dim3 grid((X + ex - 1) / ex, (Y + ey - 1) / ey, (Z + ez - 1) / ez);
  const size_t smem = (size_t)(6 * r + 1) * sizeof(T);
  star_pointwise_kernel<T, RT><<<grid, dim3(bx, by, bz), smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst),
      static_cast<const T*>(w), r, Z, Y, X, fx, fy, fz);
  return (int)cudaGetLastError();
}

template <typename T, int RT>
int launch_zmarch(const void* src, void* dst, const void* w, int r, int Z,
                  int Y, int X, int ty, int tx, int threads,
                  cudaStream_t stream) {
  const int plane = (ty + 2 * r) * (tx + 2 * r);
  if (plane > kPrefetch * threads) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(2 * r + 1) * plane + 6 * r + 1) * sizeof(T);
  const cudaError_t e = cudaFuncSetAttribute(
      star_zmarch_kernel<T, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((X + tx - 1) / tx, (Y + ty - 1) / ty, 1);
  star_zmarch_kernel<T, RT><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst),
      static_cast<const T*>(w), r, Z, Y, X, ty, tx);
  return (int)cudaGetLastError();
}

// r = 1..4 run an unrolled instantiation, any other r the generic one
template <typename T>
int dispatch_pointwise(const void* src, void* dst, const void* w, int r,
                       int Z, int Y, int X, int bx, int by, int bz, int fx,
                       int fy, int fz, cudaStream_t s) {
  switch (r) {
    case 1: return launch_pointwise<T, 1>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, s);
    case 2: return launch_pointwise<T, 2>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, s);
    case 3: return launch_pointwise<T, 3>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, s);
    case 4: return launch_pointwise<T, 4>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, s);
    default: return launch_pointwise<T, 0>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, s);
  }
}

template <typename T>
int dispatch_zmarch(const void* src, void* dst, const void* w, int r, int Z,
                    int Y, int X, int ty, int tx, int threads,
                    cudaStream_t s) {
  switch (r) {
    case 1: return launch_zmarch<T, 1>(src, dst, w, r, Z, Y, X, ty, tx, threads, s);
    case 2: return launch_zmarch<T, 2>(src, dst, w, r, Z, Y, X, ty, tx, threads, s);
    case 3: return launch_zmarch<T, 3>(src, dst, w, r, Z, Y, X, ty, tx, threads, s);
    case 4: return launch_zmarch<T, 4>(src, dst, w, r, Z, Y, X, ty, tx, threads, s);
    default: return launch_zmarch<T, 0>(src, dst, w, r, Z, Y, X, ty, tx, threads, s);
  }
}

}  // namespace

extern "C" {

// elem_bytes selects float (4) or double (8); any other value returns
// cudaErrorInvalidValue without launching.
int star_pointwise_launch(int elem_bytes, const void* src, void* dst,
                          const void* w, int r, int Z, int Y, int X, int bx,
                          int by, int bz, int fx, int fy, int fz,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 8)
    return dispatch_pointwise<double>(src, dst, w, r, Z, Y, X, bx, by, bz, fx,
                                      fy, fz, s);
  if (elem_bytes == 4)
    return dispatch_pointwise<float>(src, dst, w, r, Z, Y, X, bx, by, bz, fx,
                                     fy, fz, s);
  return (int)cudaErrorInvalidValue;
}

int star_zmarch_launch(int elem_bytes, const void* src, void* dst,
                       const void* w, int r, int Z, int Y, int X, int ty,
                       int tx, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 8)
    return dispatch_zmarch<double>(src, dst, w, r, Z, Y, X, ty, tx, threads, s);
  if (elem_bytes == 4)
    return dispatch_zmarch<float>(src, dst, w, r, Z, Y, X, ty, tx, threads, s);
  return (int)cudaErrorInvalidValue;
}

const char* star_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
