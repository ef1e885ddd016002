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
//   a ty x tx output tile.  Only the phase field is staged, in a ring of
//   (ty+2) x (tx+2) planes in dynamic shared memory from which its 7 taps
//   are read.  The PDFs are pulled straight from device memory: each PDF
//   value is read by one point only, so staging it buys no reuse (staging
//   all 18 fields as the TPU does would not fit the 232,448 B a block can
//   use).  Bound: DRAM bytes, as above.  So the design is about keeping
//   pulls in flight:
//   * A producer warp (the first warp of the CTA's first warpgroup) keeps
//     an S-stage ring of phase planes filled ahead of the consumers
//     (kernel.YTILE_STAGES: 3 in fp64, 4 in fp32, the faster of the two in
//     each, fewer where they do not fit), with no CTA barrier in the z loop.
//     Route "tma": one thread issues a TMA 3D box load per sub-tile (a
//     box's part outside the field is zero-filled), with a full and an
//     empty mbarrier per slot.  TMA needs 16-byte row strides and boxes
//     that start on 16-byte columns, and a box is at most 256 elements
//     wide, so its slot holds nb sub-tiles of w output columns each, every
//     sub-tile its w + 2 halo columns wide (rounded up to 16 bytes).  Route
//     "cp_async" (kernel.ytile_route: any field TMA does not take, or a
//     tile whose TMA ring does not fit): a slot is one (ty+2) x (tx+2)
//     plane, the warp's lanes copy it element by element with zero fill,
//     wait for their copies and arrive on a hardware named barrier, and
//     the consumers give slots back on named barriers too.  That ring holds
//     nothing but its planes, so it takes every tile that three planes fit.
//   * The consumers, 16 warps at 112 registers (setmaxnreg; the producer
//     warpgroup drops to 32), take kPoints points of a plane each per batch
//     (2 in fp64, 4 in fp32: 60 values either way) and issue all their
//     pulls before the first collide.  Pulls and stores are plain: the
//     read-only path and streaming stores measured no gain.  A plane's slot
//     goes back to the producer as soon as its last output is written.
//   * The tile and the slot layout come from the launch's arguments:
//     compile-time tiles measured no faster.  Element offsets are 32-bit
//     (the wrapper refuses fields of 2^31 elements or more).
//   * The grid is persistent: one CTA a resident slot (the occupancy
//     query), rounded down to a multiple of the tiles (kernel.ytile_ctas),
//     so that the CTAs march one tile's share of Z each, in step.  The
//     (tile, output plane) steps are cut into equal contiguous ranges, one
//     a CTA, walked tile-major, so each CTA marches one or two z segments;
//     a segment re-reads two phase planes (about 0.2 % of the bytes at
//     (256, 256, 256)), and the ring runs on from one segment into the
//     next without draining.  The tile edge is masked, so the input needs
//     no padding beyond its halo of 1.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch
// (or the tensor-map encoder's negative code).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kQ = 15;

// design switches of lbm_ytile that kernels/lbm_d3q15/ablate.py flips, one at a time.
// false: every thread fills each plane with plain loads between two CTA barriers,
// under the same register split.
constexpr bool kAsyncRing = true;
// points a consumer thread pulls before its first collide: 60 values in flight
// either way, in the 112 registers a consumer thread has
template <typename T>
constexpr int kPoints = sizeof(T) == 8 ? 2 : 4;
// true: pulls by ld.global.nc and outputs by st.global.cs, which measured no
// faster than the plain loads and stores of false
constexpr bool kCacheHints = false;
// 32-bit element offsets; false: 64-bit
constexpr bool kNarrowOffsets = true;

using Off = std::conditional_t<kNarrowOffsets, int, int64_t>;

constexpr int kRouteTma = 0;
constexpr int kRouteCpAsync = 1;
constexpr int kConsumerWarps = 16;
constexpr int kConsumers = 32 * kConsumerWarps;
// a producer warpgroup first (its first warp works), then the consumers: 96
// registers a thread at launch (5 warps on each quarter of the register file),
// which setmaxnreg moves to 32 for the producers and 112 for the consumers
constexpr int kProducers = 128;
constexpr int kYtileThreads = kProducers + kConsumers;
constexpr int kBoxMax = 256;                    // elements on each side of a TMA box
// route "cp_async" names a full and an empty barrier a slot, ids 1 .. 2S of the
// 16 (0 is __syncthreads'), each over the producer warp and the consumers
constexpr int kMaxStages = 7;
constexpr int kBarThreads = 32 + kConsumers;

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
// x-1, x+1, y-1, y+1, z-1, z+1) in; the 15 new PDFs written to out[q * n],
// by streaming stores (st.global.cs) where Streaming.
template <bool Streaming = false, typename T, typename I>
__device__ __forceinline__ void collide(const T (&h)[kQ], T phi, T xm, T xp,
                                        T ym, T yp, T zm, T zp, T tau,
                                        T kappa, T* __restrict__ out,
                                        I n) {
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
    if constexpr (Streaming) __stcs(out + q * n, h[q] - (h[q] - heq) / tau);
    else out[q * n] = h[q] - (h[q] - heq) / tau;
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

// the y-tile's geometry, computed by the wrapper (kernel.ytile_layout)
struct YtileArgs {
  int Z, Y, X;     // output domain
  int ty, tx;      // output tile
  int nb, w, bw;   // sub-tiles of a slot, output columns of each, elements of a sub-tile row
  int sub_elems;   // elements from one sub-tile to the next
  int stages;      // S
  int route;       // kRouteTma or kRouteCpAsync
};

template <typename T>
__device__ __forceinline__ T pull_load(const T* p) {
  if constexpr (kCacheHints) return __ldg(p);
  else return __ldca(p);
}

// cp.async of one N-byte element; `bytes` 0 writes zeros and reads nothing
template <int N>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
               "r"(bytes)
               : "memory");
}

// hardware named barrier `id` over `n` threads: wait for them, or arrive and go on
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The points of one output plane z of the tile at (y0, x0) that consumer
// thread i owns, kPoints at a time: all their pulls first, then collide and
// store each.  pm, pc, pp are the ring slots of padded phase planes z, z+1, z+2.
template <typename T>
__device__ __forceinline__ void ytile_plane(const T* pm, const T* pc, const T* pp,
                                            const T* __restrict__ pdf, T* __restrict__ out,
                                            const YtileArgs& a, int i, int z, int y0, int x0,
                                            T tau, T kappa) {
  constexpr int K = kPoints<T>;
  const int P = a.ty * a.tx, bw = a.bw;
  const Off sy = a.X + 2, sz = (Off)(a.Y + 2) * sy, sq = (Off)(a.Z + 2) * sz;
  const Off n = (Off)a.Z * a.Y * a.X;
  // point m of the batch at `base`: its tile coordinates, and whether it is in the domain
  auto point = [&](int base, int m, int& ly, int& lx) {
    const int p = base + i + m * kConsumers;
    ly = p / a.tx;
    lx = p - ly * a.tx;
    return p < P && y0 + ly < a.Y && x0 + lx < a.X;
  };
  for (int base = 0; base < P; base += kConsumers * K) {
    T h[K][kQ];  // every pull of the batch in flight before the first collide
#pragma unroll
    for (int m = 0; m < K; ++m) {
      int ly, lx;
      const bool ok = point(base, m, ly, lx);
      const Off c = (z + 1) * sz + (y0 + ly + 1) * sy + (x0 + lx + 1);
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        h[m][q] = ok ? pull_load(pdf + (q * sq + c - vel(q, 2) * sz - vel(q, 1) * sy -
                                        vel(q, 0)))
                     : T(0);
    }
#pragma unroll
    for (int m = 0; m < K; ++m) {
      int ly, lx;
      if (!point(base, m, ly, lx)) continue;
      const int b = lx / a.w;
      const int ci = b * a.sub_elems + (ly + 1) * bw + (lx - b * a.w) + 1;
      collide<kCacheHints>(h[m], pc[ci], pc[ci - 1], pc[ci + 1], pc[ci - bw], pc[ci + bw],
                                pm[ci], pp[ci], tau, kappa,
                                out + (((Off)z * a.Y + y0 + ly) * a.X + x0 + lx), n);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kYtileThreads, 1)
lbm_ytile_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ pdf,
                 const T* __restrict__ ph, T* __restrict__ out, const YtileArgs a, T tau,
                 T kappa) {
  extern __shared__ unsigned char smem_raw[];
  const bool tma = a.route == kRouteTma;
  // TMA writes 128-byte-aligned boxes: its ring starts at the first such address
  T* ring = reinterpret_cast<T*>(smem_raw +
                                 (tma ? (128 - smem_u32(smem_raw) % 128) % 128 : 0));
  const int ty = a.ty, tx = a.tx, nb = a.nb, w = a.w, bw = a.bw, sub = a.sub_elems;
  const int rows = ty + 2, slot_elems = nb * sub, S = a.stages;
  const int Xp = a.X + 2, Yp = a.Y + 2;
  const int tiles_x = (a.X + tx - 1) / tx;
  // the (tile, output plane) steps, tile-major, in equal contiguous ranges
  const int steps = tiles_x * ((a.Y + ty - 1) / ty) * a.Z;
  const int begin = (int)((int64_t)blockIdx.x * steps / gridDim.x);
  const int end = (int)((int64_t)(blockIdx.x + 1) * steps / gridDim.x);
  // the segment of this CTA's range that starts at step s: outputs z0 .. z0+zn-1 of
  // the tile at (y0, x0), from padded phase planes z0 .. z0+zn+1
  auto segment = [&](int s, int& y0, int& x0, int& z0, int& zn) {
    const int tile = s / a.Z;
    z0 = s - tile * a.Z;
    zn = min(a.Z - z0, end - s);
    y0 = tile / tiles_x * ty;
    x0 = tile % tiles_x * tx;
  };
  auto slot_ptr = [&](int k) { return ring + (size_t)(k % S) * slot_elems; };

  if constexpr (!kAsyncRing) {
    auto march = [&](bool consume) {
      int k = 0;  // planes so far; plane k sits in slot k % S
      for (int s = begin; s < end;) {
        int y0, x0, z0, zn;
        segment(s, y0, x0, z0, zn);
        for (int j = 0; j < zn + 2; ++j, ++k) {
          T* slot = slot_ptr(k);
          const T* plane = ph + (Off)(z0 + j) * Yp * Xp;
          for (int e = threadIdx.x; e < slot_elems; e += blockDim.x) {
            const int b = e / sub, r = (e - b * sub) / bw, col = e - b * sub - r * bw;
            const int gy = y0 + r, gx = x0 + b * w + col;
            if (r < rows) slot[e] = gy < Yp && gx < Xp ? plane[(Off)gy * Xp + gx] : T(0);
          }
          bar_sync(0, kYtileThreads);
          if (consume && j >= 2)
            ytile_plane<T>(slot_ptr(k - 2), slot_ptr(k - 1), slot, pdf, out, a,
                           threadIdx.x - kProducers, z0 + j - 2, y0, x0, tau, kappa);
          bar_sync(0, kYtileThreads);
        }
        s += zn;
      }
    };
    if (threadIdx.x < kProducers) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
      march(false);
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
      march(true);
    }
    return;
  }

  // route "tma": slot k % S's full and empty mbarriers, after the ring;
  // route "cp_async": its named barriers
  const uint32_t bars = smem_u32(ring + (size_t)S * slot_elems);
  auto full = [&](int k) { return bars + 8u * (k % S); };
  auto empty = [&](int k) { return bars + 8u * (S + k % S); };
  auto full_id = [&](int k) { return 1 + S + k % S; };
  auto empty_id = [&](int k) { return 1 + k % S; };
  if (tma && threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);                // expect_tx
      mbar_init(empty(s), kConsumerWarps);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;

  // one if/else on the warpgroup for the whole kernel: the roles never
  // reconverge, so setmaxnreg takes effect
  if (threadIdx.x < kProducers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    if (threadIdx.x >= 32 || (tma && lane != 0)) return;
    int k = 0;
    for (int s = begin; s < end;) {
      int y0, x0, z0, zn;
      segment(s, y0, x0, z0, zn);
      for (int j = 0; j < zn + 2; ++j, ++k) {
        const uint32_t dst = smem_u32(slot_ptr(k));
        if (tma) {
          if (k >= S) mbar_wait(empty(k), ((k / S) - 1) & 1);
          mbar_arrive_expect_tx(full(k), (uint32_t)(nb * rows * bw * sizeof(T)));
          for (int b = 0; b < nb; ++b)
            tma_load_3d(dst + (uint32_t)(b * sub * sizeof(T)), &map, x0 + b * w, y0, z0 + j,
                        full(k));
          continue;
        }
        // one (ty+2) x (tx+2) plane: the lanes' copies, then full once they have landed
        if (k >= S) bar_sync(empty_id(k), kBarThreads);
        const T* plane = ph + (Off)(z0 + j) * Yp * Xp;
        int r = lane / bw, col = lane % bw;  // element e = r * bw + col of the plane
        for (int e = lane; e < rows * bw; e += 32) {
          const int gy = y0 + r, gx = x0 + col;
          const bool in = gy < Yp && gx < Xp;
          cp_async_zfill<sizeof(T)>(dst + (uint32_t)(e * sizeof(T)),
                                    in ? plane + (Off)gy * Xp + gx : plane,
                                    in ? (int)sizeof(T) : 0);
          col += 32;
          while (col >= bw) {
            col -= bw;
            ++r;
          }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
        bar_arrive(full_id(k), kBarThreads);
      }
      s += zn;
    }
    // the consumers' releases of the last S planes, so that no named barrier
    // is left part-way when the CTA ends
    if (!tma)
      for (int j = max(0, k - S); j < k; ++j) bar_sync(empty_id(j), kBarThreads);
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
  auto wait_full = [&](int k) {
    if (tma) mbar_wait(full(k), (k / S) & 1);
    else bar_sync(full_id(k), kBarThreads);
  };
  auto release = [&](int k) {
    __syncwarp();
    if (!tma) bar_arrive(empty_id(k), kBarThreads);
    else if (lane == 0) mbar_arrive(empty(k));
  };
  int k = 0;
  for (int s = begin; s < end;) {
    int y0, x0, z0, zn;
    segment(s, y0, x0, z0, zn);
    wait_full(k);
    wait_full(k + 1);
    for (int j = 0; j < zn; ++j) {
      const int kj = k + j;  // output z0 + j reads planes kj, kj + 1, kj + 2
      wait_full(kj + 2);
      ytile_plane<T>(slot_ptr(kj), slot_ptr(kj + 1), slot_ptr(kj + 2), pdf, out, a,
                     threadIdx.x - kProducers, z0 + j, y0, x0, tau, kappa);
      release(kj);
    }
    release(k + zn);  // the segment's last two planes
    release(k + zn + 1);
    k += zn + 2;
    s += zn;
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

// the ring's slots; route "tma" adds its mbarriers and room to align the ring to 128 bytes
size_t ytile_smem(const YtileArgs& a, int elem_bytes) {
  const size_t ring = (size_t)a.stages * a.nb * a.sub_elems * elem_bytes;
  return a.route == kRouteTma ? ring + 16 * (size_t)a.stages + 128 : ring;
}

template <typename T>
int launch_ytile(const void* pdf, const void* ph, void* out, const YtileArgs& a, int ctas,
                 double tau, double kappa, cudaStream_t stream) {
  const size_t smem = ytile_smem(a, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(lbm_ytile_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map = {};
  if (a.route == kRouteTma) {
    const int rc = encode_3d(&map,
                             sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             sizeof(T), ph, a.X + 2, a.Y + 2, a.Z + 2, a.bw, a.ty + 2);
    if (rc != 0) return rc;
  }
  lbm_ytile_kernel<T><<<ctas, kYtileThreads, smem, stream>>>(
      map, static_cast<const T*>(pdf), static_cast<const T*>(ph), static_cast<T*>(out), a,
      T(tau), T(kappa));
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int smem) {
  cudaError_t e = cudaFuncSetAttribute(lbm_ytile_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lbm_ytile_kernel<T>, kYtileThreads,
                                                      smem);
  return e == cudaSuccess ? n : -(int)e;
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

// The geometry (nb, w, bw, sub_elems) comes from kernel.ytile_layout of the
// route.  What would let the kernel read or write outside its buffers
// returns cudaErrorInvalidValue without launching.
int lbm_ytile_launch(int elem_bytes, const void* pdf, const void* ph, void* out, int Z, int Y,
                     int X, int ty, int tx, int nb, int w, int bw, int sub_elems, int stages,
                     int route, int ctas, double tau, double kappa, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t steps = Z < 1 || Y < 1 || X < 1 || ty < 1 || tx < 1
                            ? 0
                            : (int64_t)((X + tx - 1) / tx) * ((Y + ty - 1) / ty) * Z;
  const int64_t rows = (int64_t)ty + 2;
  const bool ok =
      (elem_bytes == 4 || elem_bytes == 8) && steps >= 1 && steps < INT32_MAX &&
      stages >= 3 && stages <= kMaxStages && ctas >= 1 && ctas <= steps &&
      (route == kRouteCpAsync
           ? nb == 1 && w == tx && (int64_t)bw == (int64_t)tx + 2 && sub_elems == rows * bw
           : route == kRouteTma && nb >= 1 && w >= 1 && (int64_t)nb * w >= tx &&
                 (int64_t)(nb - 1) * w < tx && bw >= w + 2 && (bw * elem_bytes) % 16 == 0 &&
                 sub_elems >= rows * bw && (sub_elems * elem_bytes) % 128 == 0 &&
                 ((X + 2) * elem_bytes) % 16 == 0 && (tx * elem_bytes) % 16 == 0 &&
                 (w * elem_bytes) % 16 == 0 && bw <= kBoxMax && rows <= kBoxMax &&
                 reinterpret_cast<uintptr_t>(ph) % 16 == 0);
  if (!ok) return (int)cudaErrorInvalidValue;
  const YtileArgs a = {Z, Y, X, ty, tx, nb, w, bw, sub_elems, stages, route};
  return elem_bytes == 8 ? launch_ytile<double>(pdf, ph, out, a, ctas, tau, kappa, s)
                         : launch_ytile<float>(pdf, ph, out, a, ctas, tau, kappa, s);
}

// CTAs of the y-tile kernel one SM holds at once with `smem` bytes of
// dynamic shared memory, or minus a CUDA error
int lbm_ytile_blocks_per_sm(int elem_bytes, int smem) {
  if (elem_bytes == 8) return blocks_per_sm<double>(smem);
  if (elem_bytes == 4) return blocks_per_sm<float>(smem);
  return -(int)cudaErrorInvalidValue;
}

const char* lbm_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused the operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
