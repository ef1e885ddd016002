// Hand-written Hopper (sm_90a) kernels for one step of the D3Q15 Allen-Cahn
// interface-tracking LBM (paper §5.3), in float and double.
//
// For every point (z, y, x) of the (Z, Y, X) domain:
//   phi   = phase[z, y, x]
//   g     = 0.5 * (phase[.. +1 ..] - phase[.. -1 ..]) along x, y and z
//   inv   = rsqrt(g.g + 1e-12),  sharp = kappa * phi * (1 - phi)
//   for each velocity c_q (weight w_q), q = 0..14:
//     h   = pdf[q, z - cz, y - cy, x - cx]               (pull from cell - c_q)
//     heq = w_q * phi + w_q * sharp * ((c_q . g) * inv)
//     out[q, z, y, x] = h - (h - heq) / tau
// `pdf` is (15, Z+2, Y+2, X+2) and `phase` (Z+2, Y+2, X+2), both with a halo
// of 1 (padded index = domain index + 1), `out` is (15, Z, Y, X), all
// contiguous.  The arithmetic is that of repro/kernels/lbm_d3q15/kernel.py:
// _compute in its order, with every constant rounded to T first; what
// differs from the plain version is FMA contraction and rsqrt's rounding.
//
// lbm_pointwise
//   Replaces repro/kernels/lbm_d3q15/kernel.py:make_replane (grid Z; PDF q's
//   plane fetched at padded z t+1-cz, three phase planes beside it).  It is
//   the kernel the analytical GPU model prices, core/specs.py:lbm_d3q15: per
//   point 15 pull loads, 7 phase loads and 15 aligned stores, one thread per
//   (point x fold iteration) with the core/gridwalk.py:block_points mapping
//   at a LaunchConfig, exactly as star_pointwise (stencil3d25.cu) does.
//   Bound on the H100: DRAM bytes.  Each PDF value is pulled by exactly one
//   point and each output written once (240 B per point in fp64); the
//   180 flops per point need a fourteenth of that time at the fp64 rate.
//   Design: a point's 15 pull loads are issued into registers before its
//   first arithmetic, so each thread keeps them all in flight; the phase
//   field's 7-fold reuse is left to L1 and L2, which is what the estimator
//   models, so the ranked launch decides how much of it the caches absorb.
//
// lbm_ytile
//   Replaces make_ytile(ty) (grid (Y/ty, Z) with z sequential; tile j and
//   j+1 refs of all 18 fields, 36 inputs).  Blocks run in parallel on
//   Hopper, so the sequential z axis becomes a z-march inside each CTA over
//   a ty x tx output tile.  Only the phase field is staged: a ring of three
//   (ty+2) x (tx+2) planes in dynamic shared memory, from which its 7 taps
//   are read.  The PDFs are pulled straight from device memory: each PDF
//   value is read by one point only, so staging it buys no reuse (staging
//   all 18 fields as the TPU does would not fit the 232,448 B a block can
//   use).  Bound: DRAM bytes, as above.  Design: the z range is cut into
//   slabs of zs planes, one CTA per (tile, slab), because one CTA per tile
//   would leave most of the 132 SMs idle at the widths where the ring
//   fits; a slab re-reads two phase planes, which is under 1 % of the
//   bytes.  The tile edge is masked here, so the input needs no extra y
//   padding.  cp.async / TMA staging and vector loads are later work.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 15;
// threads of an lbm_ytile block; each loops over the tile's points
constexpr int kYtileThreads = 256;

// Component d (0 = x, 1 = y, 2 = z) of velocity c_q, in the order of
// core/specs.py:D3Q15_VELOCITIES.  Called with constant q and d only, in
// unrolled loops, so it folds to an immediate.
__host__ __device__ constexpr int vel(int q, int d) {
  constexpr int c[kQ][3] = {
      {0, 0, 0},
      {1, 0, 0}, {-1, 0, 0}, {0, 1, 0}, {0, -1, 0}, {0, 0, 1}, {0, 0, -1},
      {1, 1, 1}, {-1, -1, -1}, {1, 1, -1}, {-1, -1, 1},
      {1, -1, 1}, {-1, 1, -1}, {-1, 1, 1}, {1, -1, -1}};
  return c[q][d];
}

// w_q, the double quotient rounded to T (JAX's weak typing does the same)
template <typename T>
__device__ __forceinline__ T weight(int q) {
  return q == 0 ? T(2.0 / 9.0) : (q < 7 ? T(1.0 / 9.0) : T(1.0 / 72.0));
}

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

// Pull the 15 PDFs of the point whose padded centre index is `c`.
template <typename T>
__device__ __forceinline__ void pull(T (&h)[kQ], const T* __restrict__ pdf,
                                     int64_t c, int64_t sq, int64_t sz,
                                     int64_t sy) {
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    h[q] = pdf[q * sq + c - vel(q, 2) * sz - vel(q, 1) * sy - vel(q, 0)];
}

// Collide one point: its pulled PDFs h and the phase's 7 taps (centre,
// x-1, x+1, y-1, y+1, z-1, z+1) in; the 15 new PDFs written to out[q * n].
template <typename T>
__device__ __forceinline__ void collide(const T (&h)[kQ], T phi, T xm, T xp,
                                        T ym, T yp, T zm, T zp, T tau,
                                        T kappa, T* __restrict__ out,
                                        int64_t n) {
  const T gx = T(0.5) * (xp - xm);
  const T gy = T(0.5) * (yp - ym);
  const T gz = T(0.5) * (zp - zm);
  const T inv = rsqrt_t(gx * gx + gy * gy + gz * gz + T(1e-12));
  const T sharp = kappa * phi * (T(1) - phi);
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const T w = weight<T>(q);
    const T cdotn = (T(vel(q, 0)) * gx + T(vel(q, 1)) * gy + T(vel(q, 2)) * gz) * inv;
    const T heq = w * phi + w * sharp * cdotn;
    out[q * n] = h[q] - (h[q] - heq) / tau;
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
lbm_pointwise_kernel(const T* __restrict__ pdf, const T* __restrict__ ph,
                     T* __restrict__ out, int Z, int Y, int X, int fx, int fy,
                     int fz, T tau, T kappa) {
  const int64_t sy = X + 2;
  const int64_t sz = (int64_t)(Y + 2) * sy;
  const int64_t sq = (int64_t)(Z + 2) * sz;
  const int64_t n = (int64_t)Z * Y * X;
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
        const int64_t c = (z + 1) * sz + (y + 1) * sy + (x + 1);
        T h[kQ];
        pull(h, pdf, c, sq, sz, sy);
        const T* p = ph + c;
        collide(h, p[0], p[-1], p[1], p[-sy], p[sy], p[-sz], p[sz], tau, kappa,
                out + ((int64_t)z * Y + y) * X + x, n);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kYtileThreads)
lbm_ytile_kernel(const T* __restrict__ pdf, const T* __restrict__ ph,
                 T* __restrict__ out, int Z, int Y, int X, int ty, int tx,
                 int zs, T tau, T kappa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int Xp = X + 2;
  const int Yp = Y + 2;
  const int64_t sy = Xp;
  const int64_t sz = (int64_t)Yp * Xp;
  const int64_t sq = (int64_t)(Z + 2) * sz;
  const int64_t n = (int64_t)Z * Y * X;
  const int hx = tx + 2;  // halo tile row length
  const int plane = (ty + 2) * hx;
  // tile origin: output (y0, x0) is padded (y0 + 1, x0 + 1), so the halo
  // tile starts at padded (y0, x0)
  const int y0 = blockIdx.y * ty;
  const int x0 = blockIdx.x * tx;
  const int zb = blockIdx.z * zs;
  const int ze = min(Z, zb + zs);
  // padded phase planes zb .. ze+1 feed output planes zb .. ze-1
  for (int t = zb; t < ze + 2; ++t) {
    // plane t into ring slot t mod 3; that slot held plane t-3, whose last
    // reader was step t-1 (barrier at loop end)
    T* slot = ring + (t % 3) * plane;
    const T* src = ph + t * sz;
    for (int i = threadIdx.x; i < plane; i += blockDim.x) {
      const int ly = i / hx;
      const int gy = y0 + ly;
      const int gx = x0 + (i - ly * hx);
      slot[i] = (gy < Yp && gx < Xp) ? src[(int64_t)gy * Xp + gx] : T(0);
    }
    __syncthreads();
    if (t >= zb + 2) {
      const int z = t - 2;  // output plane: padded planes z, z+1, z+2
      const T* pm = ring + (z % 3) * plane;
      const T* pc = ring + ((z + 1) % 3) * plane;
      const T* pp = slot;
      for (int i = threadIdx.x; i < ty * tx; i += blockDim.x) {
        const int ly = i / tx;
        const int lx = i - ly * tx;
        const int y = y0 + ly;
        const int x = x0 + lx;
        if (y >= Y || x >= X) continue;
        T h[kQ];
        pull(h, pdf, (z + 1) * sz + (y + 1) * sy + (x + 1), sq, sz, sy);
        const int ci = (ly + 1) * hx + (lx + 1);
        collide(h, pc[ci], pc[ci - 1], pc[ci + 1], pc[ci - hx], pc[ci + hx],
                pm[ci], pp[ci], tau, kappa, out + ((int64_t)z * Y + y) * X + x, n);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_pointwise(const void* pdf, const void* ph, void* out, int Z, int Y,
                     int X, int bx, int by, int bz, int fx, int fy, int fz,
                     double tau, double kappa, cudaStream_t stream) {
  const int ex = bx * fx, ey = by * fy, ez = bz * fz;
  const dim3 grid((X + ex - 1) / ex, (Y + ey - 1) / ey, (Z + ez - 1) / ez);
  lbm_pointwise_kernel<T><<<grid, dim3(bx, by, bz), 0, stream>>>(
      static_cast<const T*>(pdf), static_cast<const T*>(ph), static_cast<T*>(out),
      Z, Y, X, fx, fy, fz, T(tau), T(kappa));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ytile(const void* pdf, const void* ph, void* out, int Z, int Y,
                 int X, int ty, int tx, int zs, double tau, double kappa,
                 cudaStream_t stream) {
  const size_t smem = (size_t)3 * (ty + 2) * (tx + 2) * sizeof(T);
  const cudaError_t e = cudaFuncSetAttribute(
      lbm_ytile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((X + tx - 1) / tx, (Y + ty - 1) / ty, (Z + zs - 1) / zs);
  lbm_ytile_kernel<T><<<grid, kYtileThreads, smem, stream>>>(
      static_cast<const T*>(pdf), static_cast<const T*>(ph), static_cast<T*>(out),
      Z, Y, X, ty, tx, zs, T(tau), T(kappa));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// elem_bytes selects float (4) or double (8); any other value returns
// cudaErrorInvalidValue without launching.
int lbm_pointwise_launch(int elem_bytes, const void* pdf, const void* ph,
                         void* out, int Z, int Y, int X, int bx, int by, int bz,
                         int fx, int fy, int fz, double tau, double kappa,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 8)
    return launch_pointwise<double>(pdf, ph, out, Z, Y, X, bx, by, bz, fx, fy,
                                    fz, tau, kappa, s);
  if (elem_bytes == 4)
    return launch_pointwise<float>(pdf, ph, out, Z, Y, X, bx, by, bz, fx, fy,
                                   fz, tau, kappa, s);
  return (int)cudaErrorInvalidValue;
}

int lbm_ytile_launch(int elem_bytes, const void* pdf, const void* ph, void* out,
                     int Z, int Y, int X, int ty, int tx, int zs, double tau,
                     double kappa, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 8)
    return launch_ytile<double>(pdf, ph, out, Z, Y, X, ty, tx, zs, tau, kappa, s);
  if (elem_bytes == 4)
    return launch_ytile<float>(pdf, ph, out, Z, Y, X, ty, tx, zs, tau, kappa, s);
  return (int)cudaErrorInvalidValue;
}

const char* lbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
