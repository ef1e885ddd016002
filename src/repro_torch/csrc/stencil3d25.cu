// Hand-written Hopper (sm_90a) kernels for the range-r 3D star stencil
// (paper §5.2; r = 4 is the 25-point stencil), in float and double.
//
//   dst[z,y,x] = w[0]*src[z,y,x]
//              + sum over axis (z, y, x), o = 1..r, s = -o, +o of w[k]*src[.. +s ..]
//
// `src` is the (Z+2r, Y+2r, X+2r) halo-padded field, `dst` is (Z, Y, X), both
// contiguous; `w` holds the 6r+1 weights in the order of ref.py: centre, then
// (z,-1), (z,+1), ..., (z,-r), (z,+r), then the same for y, then for x.
//
// Weights.  For r = 1..4 (kBankRange, the unrolled instantiations) both
// kernels read them from the constant bank (c_w64 / c_w32).  The launcher
// copies them there from the weights tensor with cudaMemcpyToSymbolAsync on
// the launch stream, right before the launch; the host never waits.  With r
// a compile-time constant each multiply-add then takes its weight as a
// constant-bank operand and no load is issued for it.  Any other r runs the
// generic instantiation (RT = 0), which reads its weights from the weights
// tensor through the read-only path (ld.global.nc), so the card takes every
// r the reference takes.
//
// The bank is one per device and dtype, not one per launch, so it is
// guarded (with_bank): each bank keeps the stream of the last launch that
// read it and an event recorded on that stream after the launch.  A launch
// on another stream first makes its own stream wait for that event
// (cudaStreamWaitEvent), then fills the bank and launches; every launch then
// records the event on its stream.  The host never waits, and launches on
// one stream pay only the event record.  A host mutex keeps each wait, fill,
// launch and record together when several host threads launch at once.
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
//   rate).  The 2r+1 re-reads of each element along z, y and x are left to
//   L1 and L2, which is what the estimator models, so the ranking's launch
//   decides how much of the re-read traffic the caches absorb.  That priced
//   access stream is fixed: the points of each thread and the 6r+1 global
//   loads of each point, in tap order.  The design changes only what lies
//   around it:
//   * weights from the constant bank (r = 1..4; the generic instantiation
//     reads them from w): no shared load beside each global one on the
//     load/store pipe, and no barrier;
//   * for r = 1..4 (unrolled instantiations; any other r runs a generic
//     one) all 6r+1 loads of a point are issued into a register array
//     before the first multiply-add, then summed in tap order
//     (acc = acc + w*v), so the plain version differs only by FMA
//     contraction;
//   * 32-bit offsets when the padded field has fewer than 2^31 elements,
//     64-bit ones otherwise (kernel.pointwise_offset_bits).
//   One __launch_bounds__(1024) serves every block: all 168 priced launches
//   have 1024 threads, and ptxas keeps the ranked instantiation at 32
//   registers, so a cap that followed the block would act only on pinned
//   smaller blocks.
//
// star_zmarch
//   Replaces make_ring (grid Z+2r, one padded plane loaded per step into a
//   (2r+1)-plane VMEM ring) and make_ytile_ring(ty) (the same ring over
//   ty-row tiles).  Blocks run in parallel on Hopper, so the TPU's sequential
//   grid axis becomes a loop inside the block: each CTA owns a TY x TX output
//   tile and one segment of Z (kernel.zmarch_segments splits Z when whole
//   waves of CTAs then fit the card better; a segment re-reads 2r halo
//   planes) and marches over the segment's padded planes.
//   * A producer, the CTA's last warp, keeps an S-stage ring of halo planes
//     in flight, each rows x bw elements (rows = TY rounded up to CY, plus
//     2r; bw = TX + 2r rounded up to 16 bytes, wider where tiles start off
//     16-byte boundaries: a slot's rows start at the boundary at or below
//     the tile's first halo column, as a TMA box must), with full and empty
//     mbarriers and no CTA barrier in the z loop.  Route "tma": one thread
//     issues a TMA 3D box load per plane (the box's part outside the field
//     is zero-filled); TMA needs 16-byte row strides.  Route "cp_async": the
//     warp's 32 lanes copy the plane element by element with zero fill, for
//     any row stride (kernel.zmarch_route names the route).
//   * The consumers, all other threads (at most 256), own CY consecutive
//     rows (2, 4 or 8, kernel.zmarch_rows) of one output column x of the
//     tile.  For r = 1..4 the z taps stay in registers as 2r+1 partial sums
//     a row (any other r reads all 6r+1 taps of an output from a ring of
//     2r+2 planes, in tap order, with its weights from w): plane t adds its value
//     at the column's centre to the sums of the outputs t-2r .. t (output
//     planes, padded plane t is the centre of output t-r) with their z
//     weights, and to output t-r the centre, y and x taps of that plane.
//     So only the plane's centre, y and x taps come from shared memory:
//     CY + 2r values of the column and 2r a row along x (13 loads a point at
//     CY = 2, r = 4, where the first version read 25 taps and 25 weights
//     from shared memory).  A plane's slot is released once its taps have
//     been summed, so 2-4 stages keep the loads in flight.
//   * Sum order per output: (z,-r), (z,-r+1), ..., (z,-1), centre, (y,-1),
//     (y,+1), ..., (y,+r), (x,-1), ..., (x,+r), (z,+1), ..., (z,+r): the z
//     taps below the centre come first, nearest last.  ref.py's
//     star_stencil_zsum_ref is the plain version of that order; the kernel
//     differs from it only by FMA contraction.
//   Bound on the H100: DRAM bytes.  Each padded element comes from L2 once
//   per tile that covers it (halo overhead (TY+2r)(TX+2r)/(TY*TX)); the
//   multiply-adds are 6r+1 a point as in star_pointwise.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch
// (or the tensor-map encoder's negative code).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "sm90.cuh"

namespace {

constexpr int kBankRange = 4;                // r up to which the weights sit in the constant bank
constexpr int kBankTaps = 6 * kBankRange + 1;

// design switches that kernels/stencil3d25/ablate.py flips, one at a time.
// star_pointwise's weights: false stages them in shared memory per block.
constexpr bool kConstWeights = true;
// both kernels' weights at r <= kBankRange: false reads them from w through
// the read-only path, as the generic instantiations do, and fills no bank.
constexpr bool kBankWeights = true;
// star_zmarch's z taps: false reads all 6r+1 taps from the ring, in tap
// order, which then holds the 2r+1 planes of an output (stages >= 2r+2).
constexpr bool kZInRegisters = true;

constexpr int kRouteTma = 0;
constexpr int kRouteCpAsync = 1;
// at most 256 consumer threads and the producer warp: 9 warps leave 168
// registers a thread (the register file's quarters hold 3 warps each)
constexpr int kZmarchMaxThreads = 288;

__constant__ double c_w64[kBankTaps];
__constant__ float c_w32[kBankTaps];

template <typename T>
__device__ __forceinline__ T cweight(int k);
template <>
__device__ __forceinline__ double cweight<double>(int k) { return c_w64[k]; }
template <>
__device__ __forceinline__ float cweight<float>(int k) { return c_w32[k]; }

// the n weights at device address w into the constant bank, on `s`
template <typename T>
cudaError_t upload_weights(const void* w, int n, cudaStream_t s);
template <>
cudaError_t upload_weights<double>(const void* w, int n, cudaStream_t s) {
  return cudaMemcpyToSymbolAsync(c_w64, w, n * sizeof(double), 0, cudaMemcpyDeviceToDevice, s);
}
template <>
cudaError_t upload_weights<float>(const void* w, int n, cudaStream_t s) {
  return cudaMemcpyToSymbolAsync(c_w32, w, n * sizeof(float), 0, cudaMemcpyDeviceToDevice, s);
}

constexpr int kMaxDevices = 64;

// One constant bank (one dtype on one device): the stream of the last launch
// that read it, and an event recorded on that stream after that launch.
struct BankGuard {
  cudaStream_t stream = nullptr;
  cudaEvent_t done = nullptr;
};
BankGuard g_banks[kMaxDevices][2];
std::mutex g_bank_mutex;
long long g_bank_fills = 0;  // fills of a bank, for the tests and the smoke run
long long g_bank_waits = 0;  // of which on another stream than the bank's last launch

// Fill the bank of T on the current device with the n weights at w and call
// launch() on stream s, ordered after the last launch that read the bank (on
// whatever stream); returns launch()'s code or the first CUDA error.
template <typename T, typename Launch>
int with_bank(const void* w, int n, cudaStream_t s, Launch launch) {
  std::lock_guard<std::mutex> lock(g_bank_mutex);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  BankGuard& g = g_banks[dev][sizeof(T) == 8];
  if (g.done == nullptr) {
    e = cudaEventCreateWithFlags(&g.done, cudaEventDisableTiming);
  } else if (g.stream != s) {
    e = cudaStreamWaitEvent(s, g.done, 0);
    ++g_bank_waits;
  }
  if (e != cudaSuccess) return (int)e;
  e = upload_weights<T>(w, n, s);
  if (e != cudaSuccess) return (int)e;
  ++g_bank_fills;
  const int rc = launch();
  // recorded even when the launch failed: the fill on s is queued all the same
  e = cudaEventRecord(g.done, s);
  g.stream = s;
  return rc != 0 ? rc : (int)e;
}

// Copy the 6r+1 weights into shared memory (kConstWeights = false only).
template <typename T>
__device__ __forceinline__ void stage_weights(T* ws, const T* __restrict__ w,
                                              int n, int tid, int nthreads) {
  for (int k = tid; k < n; k += nthreads) ws[k] = w[k];
  __syncthreads();
}

// RT > 0: the range r = RT is a compile-time constant, every tap loop
// unrolls and the weights come from the constant bank; RT == 0 takes r from
// the runtime argument (any r) and its weights from w.  Idx is the type of
// the element offsets (int below 2^31 elements).
template <typename T, int RT, typename Idx>
__global__ void __launch_bounds__(1024)
star_pointwise_kernel(const T* __restrict__ src, T* __restrict__ dst,
                      const T* __restrict__ w, int r_arg, int Z, int Y, int X,
                      int fx, int fy, int fz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  const int r = RT > 0 ? RT : r_arg;
  if constexpr (RT > 0 && !kConstWeights) {
    const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
    stage_weights(ws, w, 6 * r + 1, tid, blockDim.x * blockDim.y * blockDim.z);
  }
  auto wt = [&](int k) -> T {
    if constexpr (RT == 0) return __ldg(w + k);
    else if constexpr (!kConstWeights) return ws[k];
    else if constexpr (kBankWeights) return cweight<T>(k);
    else return __ldg(w + k);
  };
  const Idx Xp = X + 2 * r;
  const Idx Yp = Y + 2 * r;
  const Idx sy = Xp;
  const Idx sz = Yp * Xp;
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
        const T* c = src + ((Idx)(z + r) * Yp + (y + r)) * Xp + (x + r);
        T acc;
        if constexpr (RT > 0) {
          T v[6 * RT + 1];  // every tap in flight before the first multiply-add
          v[0] = c[0];
#pragma unroll
          for (int o = 1; o <= RT; ++o) {
            v[2 * o - 1] = c[-o * sz];
            v[2 * o] = c[o * sz];
          }
#pragma unroll
          for (int o = 1; o <= RT; ++o) {
            v[2 * RT + 2 * o - 1] = c[-o * sy];
            v[2 * RT + 2 * o] = c[o * sy];
          }
#pragma unroll
          for (int o = 1; o <= RT; ++o) {
            v[4 * RT + 2 * o - 1] = c[-o];
            v[4 * RT + 2 * o] = c[o];
          }
          acc = wt(0) * v[0];
#pragma unroll
          for (int k = 1; k <= 6 * RT; ++k) acc = acc + wt(k) * v[k];
        } else {
          acc = wt(0) * c[0];
          for (int o = 1; o <= r; ++o) {
            acc = acc + wt(2 * o - 1) * c[-o * sz];
            acc = acc + wt(2 * o) * c[o * sz];
          }
          for (int o = 1; o <= r; ++o) {
            acc = acc + wt(2 * r + 2 * o - 1) * c[-o * sy];
            acc = acc + wt(2 * r + 2 * o) * c[o * sy];
          }
          for (int o = 1; o <= r; ++o) {
            acc = acc + wt(4 * r + 2 * o - 1) * c[-o];
            acc = acc + wt(4 * r + 2 * o) * c[o];
          }
        }
        dst[((Idx)z * Y + y) * X + x] = acc;
      }
    }
  }
}

// the z-march's geometry, computed by the wrapper (kernel.zmarch_layout)
struct ZmarchArgs {
  int r, Z, Y, X;   // range and output domain
  int ty, tx;       // output tile
  int rows, bw;     // one ring slot: rows x bw elements
  int slot_elems;   // elements from one slot to the next (a 128-byte multiple)
  int stages;       // S
  int zlen;         // outputs of one z segment
  int route;        // kRouteTma or kRouteCpAsync
};

// cp.async of one N-byte element; `bytes` 0 writes zeros and reads nothing
template <int N>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
               "r"(bytes)
               : "memory");
}

// one arrival on `bar` once every earlier cp.async of this thread has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// RT as in star_pointwise_kernel: RT > 0 keeps the z taps in registers
// (kZInRegisters), RT == 0 reads every tap of an output from the ring, which
// then holds its 2r+1 planes (stages >= 2r+2), with the weights from w.
// CY output rows per consumer thread.
template <typename T, int RT, int CY>
__global__ void __launch_bounds__(kZmarchMaxThreads)
star_zmarch_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ src,
                   T* __restrict__ dst, const T* __restrict__ w, const ZmarchArgs a) {
  extern __shared__ unsigned char smem_raw[];
  // TMA writes 128-byte-aligned boxes: the ring starts at the first such address
  T* ring = reinterpret_cast<T*>(smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128));
  const int S = a.stages;
  const uint32_t bars = smem_u32(ring + (size_t)S * a.slot_elems);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };
  const int r = RT > 0 ? RT : a.r;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cwarps = (blockDim.x >> 5) - 1;  // the last warp produces
  const int x0 = blockIdx.x * a.tx, y0 = blockIdx.y * a.ty, z0 = blockIdx.z * a.zlen;
  // a slot's rows start at the 16-byte boundary at or below the tile's first
  // halo column, where a TMA box may start; the tile sits xoff columns in
  const int xoff = x0 % (16 / (int)sizeof(T)), xb = x0 - xoff;
  const int nplanes = min(a.zlen, a.Z - z0) + 2 * r;  // padded planes z0 .. z0+nplanes-1
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), a.route == kRouteTma ? 1 : 32);  // expect_tx, or one arrival a lane
      mbar_init(empty(s), cwarps);                         // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == cwarps) {  // the producer
    if (a.route == kRouteTma) {
      if (lane == 0) {
        const uint32_t box = (uint32_t)(a.rows * a.bw * sizeof(T));
        for (int k = 0; k < nplanes; ++k) {
          const int s = k % S;
          if (k >= S) mbar_wait(empty(s), ((k / S) - 1) & 1);
          mbar_arrive_expect_tx(full(s), box);
          tma_load_3d(smem_u32(ring + (size_t)s * a.slot_elems), &map, xb, y0, z0 + k, full(s));
        }
      }
    } else {
      const int Xp = a.X + 2 * r, Yp = a.Y + 2 * r;
      const int n = a.rows * a.bw;
      for (int k = 0; k < nplanes; ++k) {
        const int s = k % S;
        if (k >= S) mbar_wait(empty(s), ((k / S) - 1) & 1);
        const T* plane = src + (int64_t)(z0 + k) * Yp * Xp;
        const uint32_t slot = smem_u32(ring + (size_t)s * a.slot_elems);
        int ly = lane / a.bw, lx = lane % a.bw;  // element i = ly * bw + lx of the slot
        for (int i = lane; i < n; i += 32) {
          const int gy = y0 + ly, gx = xb + lx;
          const bool in = gy < Yp && gx < Xp;
          cp_async_zfill<sizeof(T)>(slot + i * (int)sizeof(T),
                                    in ? plane + (int64_t)gy * Xp + gx : plane,
                                    in ? (int)sizeof(T) : 0);
          lx += 32;
          while (lx >= a.bw) {
            lx -= a.bw;
            ++ly;
          }
        }
        cp_async_arrive(full(s));
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    return;
  }

  // the consumers
  const int ncons = (a.ty + CY - 1) / CY * a.tx;
  const int i = min((int)threadIdx.x, ncons - 1);  // threads past the tile repeat its last column
  const int lx = i % a.tx, ly0 = i / a.tx * CY;
  const int x = x0 + lx, y = y0 + ly0;
  const bool col_ok = (int)threadIdx.x < ncons && x < a.X;
  bool keep[CY];
#pragma unroll
  for (int q = 0; q < CY; ++q) keep[q] = col_ok && ly0 + q < a.ty && y + q < a.Y;
  const int64_t plane_out = (int64_t)a.Y * a.X;
  T* out = dst + ((int64_t)z0 * a.Y + y) * a.X + x;
  const int col0 = ly0 * a.bw + xoff + lx + r;  // the column's top row in a slot
  auto wt = [&](int k) -> T {
    if constexpr (RT == 0 || !kBankWeights) return __ldg(w + k);
    else return cweight<T>(k);
  };

  if constexpr (kZInRegisters && RT > 0) {
    constexpr int NACC = 2 * RT + 1;  // partial sums a row keeps
    constexpr int NCOL = CY + 2 * RT;
    constexpr int NX = 2 * RT;
    T acc[CY][NACC];
#pragma unroll
    for (int q = 0; q < CY; ++q)
#pragma unroll
      for (int m = 0; m < NACC; ++m) acc[q][m] = T(0);
    // unrolled by NACC, so that the sum of the output begun at step k - m
    // sits in acc[.][(j - m) mod NACC], a register when r is a constant
    for (int kb = 0; kb < nplanes; kb += NACC) {
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int k = kb + j;
        if (k >= nplanes) break;
        const int s = k % S;
        mbar_wait(full(s), (k / S) & 1);
        const T* p = ring + (size_t)s * a.slot_elems + col0;
        T cv[NCOL], xv[CY][NX];
#pragma unroll
        for (int q = 0; q < CY + 2 * r; ++q) cv[q] = p[q * a.bw];
#pragma unroll
        for (int q = 0; q < CY; ++q)
#pragma unroll
          for (int o = 1; o <= r; ++o) {
            xv[q][2 * o - 2] = p[(q + r) * a.bw - o];
            xv[q][2 * o - 1] = p[(q + r) * a.bw + o];
          }
#pragma unroll
        for (int q = 0; q < CY; ++q) {
          const T c = cv[q + r];
#pragma unroll
          for (int m = 0; m <= 2 * r; ++m) {  // the output begun at step k - m: z tap m - r
            T& sum = acc[q][(j - m + NACC) % NACC];
            if (m == 0) {
              sum = wt(2 * r - 1) * c;
            } else if (m < r) {
              sum = sum + wt(2 * (r - m) - 1) * c;
            } else if (m == r) {
              sum = sum + wt(0) * c;
#pragma unroll
              for (int o = 1; o <= r; ++o) {
                sum = sum + wt(2 * r + 2 * o - 1) * cv[q + r - o];
                sum = sum + wt(2 * r + 2 * o) * cv[q + r + o];
              }
#pragma unroll
              for (int o = 1; o <= r; ++o) {
                sum = sum + wt(4 * r + 2 * o - 1) * xv[q][2 * o - 2];
                sum = sum + wt(4 * r + 2 * o) * xv[q][2 * o - 1];
              }
            } else {
              sum = sum + wt(2 * (m - r)) * c;
            }
          }
          if (k >= 2 * r && keep[q])
            out[(int64_t)(k - 2 * r) * plane_out + q * a.X] = acc[q][(j - 2 * r + NACC) % NACC];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
    }
  } else {
    for (int k = 0; k < nplanes; ++k) {
      mbar_wait(full(k % S), (k / S) & 1);
      if (k < 2 * r) continue;
      // output k - 2r of the segment, from its planes k - 2r .. k
      const T* pc = ring + (size_t)((k - r) % S) * a.slot_elems + col0;
#pragma unroll
      for (int q = 0; q < CY; ++q) {
        const int ci = (q + r) * a.bw;
        T sum = wt(0) * pc[ci];
        for (int o = 1; o <= r; ++o) {
          sum = sum + wt(2 * o - 1) * ring[(size_t)((k - r - o) % S) * a.slot_elems + col0 + ci];
          sum = sum + wt(2 * o) * ring[(size_t)((k - r + o) % S) * a.slot_elems + col0 + ci];
        }
        for (int o = 1; o <= r; ++o) {
          sum = sum + wt(2 * r + 2 * o - 1) * pc[ci - o * a.bw];
          sum = sum + wt(2 * r + 2 * o) * pc[ci + o * a.bw];
        }
        for (int o = 1; o <= r; ++o) {
          sum = sum + wt(4 * r + 2 * o - 1) * pc[ci - o];
          sum = sum + wt(4 * r + 2 * o) * pc[ci + o];
        }
        if (keep[q]) out[(int64_t)(k - 2 * r) * plane_out + q * a.X] = sum;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((k - 2 * r) % S));
    }
  }
}

template <typename T, int RT, typename Idx>
int go_pointwise(const void* src, void* dst, const void* w, int r, int Z, int Y, int X, int bx,
                 int by, int bz, int fx, int fy, int fz, cudaStream_t stream) {
  const int ex = bx * fx, ey = by * fy, ez = bz * fz;
  const dim3 grid((X + ex - 1) / ex, (Y + ey - 1) / ey, (Z + ez - 1) / ez);
  const size_t smem = RT > 0 && !kConstWeights ? (size_t)(6 * r + 1) * sizeof(T) : 0;
  auto launch = [&]() {
    star_pointwise_kernel<T, RT, Idx><<<grid, dim3(bx, by, bz), smem, stream>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), static_cast<const T*>(w), r, Z, Y, X,
        fx, fy, fz);
    return (int)cudaGetLastError();
  };
  if (RT > 0 && kConstWeights && kBankWeights) return with_bank<T>(w, 6 * r + 1, stream, launch);
  return launch();
}

// wide: 64-bit offsets (the wrapper's size rule; the ablation forces them)
template <typename T, int RT>
int launch_pointwise(const void* src, void* dst, const void* w, int r, int Z, int Y, int X, int bx,
                     int by, int bz, int fx, int fy, int fz, int wide, cudaStream_t s) {
  if (wide)
    return go_pointwise<T, RT, int64_t>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, s);
  return go_pointwise<T, RT, int>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, s);
}

// r = 1..4 (kBankRange) run an unrolled instantiation, any other r the
// generic one
template <typename T>
int dispatch_pointwise(const void* src, void* dst, const void* w, int r, int Z, int Y, int X,
                       int bx, int by, int bz, int fx, int fy, int fz, int wide,
                       cudaStream_t s) {
  switch (r) {
    case 1: return launch_pointwise<T, 1>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, wide, s);
    case 2: return launch_pointwise<T, 2>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, wide, s);
    case 3: return launch_pointwise<T, 3>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, wide, s);
    case 4: return launch_pointwise<T, 4>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, wide, s);
    default: return go_pointwise<T, 0, int64_t>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, s);
  }
}

// the ring's slots and mbarriers, and room to align the ring to 128 bytes
size_t zmarch_smem(const ZmarchArgs& a, int elem_bytes) {
  return (size_t)a.stages * (a.slot_elems * elem_bytes + 16) + 128;
}

template <typename T, int RT, int CY>
int launch_zmarch(const void* src, void* dst, const void* w, const ZmarchArgs& a, int threads,
                  int segments, cudaStream_t stream) {
  const size_t smem = zmarch_smem(a, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(star_zmarch_kernel<T, RT, CY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map = {};
  if (a.route == kRouteTma) {
    const int rc = encode_3d(&map,
                             sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             sizeof(T), src, a.X + 2 * a.r, a.Y + 2 * a.r, a.Z + 2 * a.r, a.bw,
                             a.rows);
    if (rc != 0) return rc;
  }
  const dim3 grid((a.X + a.tx - 1) / a.tx, (a.Y + a.ty - 1) / a.ty, segments);
  auto launch = [&]() {
    star_zmarch_kernel<T, RT, CY><<<grid, threads, smem, stream>>>(
        map, static_cast<const T*>(src), static_cast<T*>(dst), static_cast<const T*>(w), a);
    return (int)cudaGetLastError();
  };
  if (RT > 0 && kBankWeights) return with_bank<T>(w, 6 * a.r + 1, stream, launch);
  return launch();
}

template <typename T, int CY>
int dispatch_zmarch_r(const void* src, void* dst, const void* w, const ZmarchArgs& a, int threads,
                      int segments, cudaStream_t s) {
  switch (a.r) {
    case 1: return launch_zmarch<T, 1, CY>(src, dst, w, a, threads, segments, s);
    case 2: return launch_zmarch<T, 2, CY>(src, dst, w, a, threads, segments, s);
    case 3: return launch_zmarch<T, 3, CY>(src, dst, w, a, threads, segments, s);
    case 4: return launch_zmarch<T, 4, CY>(src, dst, w, a, threads, segments, s);
    default: return launch_zmarch<T, 0, CY>(src, dst, w, a, threads, segments, s);
  }
}

template <typename T>
int dispatch_zmarch(const void* src, void* dst, const void* w, const ZmarchArgs& a, int cy,
                    int threads, int segments, cudaStream_t s) {
  switch (cy) {
    case 2: return dispatch_zmarch_r<T, 2>(src, dst, w, a, threads, segments, s);
    case 4: return dispatch_zmarch_r<T, 4>(src, dst, w, a, threads, segments, s);
    default: return dispatch_zmarch_r<T, 8>(src, dst, w, a, threads, segments, s);
  }
}

// the occupancy query behind kernel.zmarch_segments
template <typename T, int CY>
int blocks_per_sm(int r, int threads, int smem) {
  auto kern = r == 1 ? star_zmarch_kernel<T, 1, CY>
            : r == 2 ? star_zmarch_kernel<T, 2, CY>
            : r == 3 ? star_zmarch_kernel<T, 3, CY>
            : r == 4 ? star_zmarch_kernel<T, 4, CY>
                     : star_zmarch_kernel<T, 0, CY>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

// elem_bytes selects float (4) or double (8); r < 1 and any other
// elem_bytes return cudaErrorInvalidValue without launching.
int star_pointwise_launch(int elem_bytes, const void* src, void* dst, const void* w, int r, int Z,
                          int Y, int X, int bx, int by, int bz, int fx, int fy, int fz, int wide,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r < 1) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 8)
    return dispatch_pointwise<double>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, wide, s);
  if (elem_bytes == 4)
    return dispatch_pointwise<float>(src, dst, w, r, Z, Y, X, bx, by, bz, fx, fy, fz, wide, s);
  return (int)cudaErrorInvalidValue;
}

// The geometry (cy, rows, bw, slot_elems, threads) comes from
// kernel.zmarch_layout; what would let the kernel read or write outside
// its buffers returns cudaErrorInvalidValue without launching.
int star_zmarch_launch(int elem_bytes, const void* src, void* dst, const void* w, int r, int Z,
                       int Y, int X, int ty, int tx, int cy, int rows, int bw, int slot_elems,
                       int stages, int segments, int route, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (ty + cy - 1) / cy;
  const int zlen = segments >= 1 ? (Z + segments - 1) / segments : 0;
  const bool ok =
      (elem_bytes == 4 || elem_bytes == 8) && r >= 1 && ty >= 1 && tx >= 1 &&
      (cy == 2 || cy == 4 || cy == 8) && rows >= groups * cy + 2 * r &&
      bw >= tx + 2 * r + ((tx * elem_bytes) % 16 ? 16 / elem_bytes - 1 : 0) &&
      slot_elems >= rows * bw && (slot_elems * elem_bytes) % 128 == 0 &&
      threads >= groups * tx + 32 && threads % 32 == 0 && threads <= kZmarchMaxThreads &&
      stages >= (kZInRegisters && r <= kBankRange ? 2 : 2 * r + 2) && zlen >= 1 && (Z + zlen - 1) / zlen == segments &&
      (route == kRouteCpAsync ||
       (route == kRouteTma && ((X + 2 * r) * elem_bytes) % 16 == 0 && (bw * elem_bytes) % 16 == 0 &&
        bw <= 256 && rows <= 256 && reinterpret_cast<uintptr_t>(src) % 16 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const ZmarchArgs a = {r, Z, Y, X, ty, tx, rows, bw, slot_elems, stages, zlen, route};
  return elem_bytes == 8 ? dispatch_zmarch<double>(src, dst, w, a, cy, threads, segments, s)
                         : dispatch_zmarch<float>(src, dst, w, a, cy, threads, segments, s);
}

// CTAs of the z-march kernel one SM holds at once, or minus a CUDA error
int star_zmarch_blocks_per_sm(int elem_bytes, int r, int cy, int threads, int smem) {
  if (elem_bytes == 8)
    return cy == 2 ? blocks_per_sm<double, 2>(r, threads, smem)
         : cy == 4 ? blocks_per_sm<double, 4>(r, threads, smem)
                   : blocks_per_sm<double, 8>(r, threads, smem);
  return cy == 2 ? blocks_per_sm<float, 2>(r, threads, smem)
       : cy == 4 ? blocks_per_sm<float, 4>(r, threads, smem)
                 : blocks_per_sm<float, 8>(r, threads, smem);
}

// fills of the constant banks so far in this process, and of them those that
// waited for a launch on another stream (with_bank)
long long star_bank_fills() {
  std::lock_guard<std::mutex> lock(g_bank_mutex);
  return g_bank_fills;
}

long long star_bank_waits() {
  std::lock_guard<std::mutex> lock(g_bank_mutex);
  return g_bank_waits;
}

const char* star_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused the operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
