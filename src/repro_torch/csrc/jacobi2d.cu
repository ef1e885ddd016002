// Hand-written Hopper (sm_90a) kernels for the weighted 2D 5-point Jacobi
// sweep, in float and double.
//
//   dst[y,x] = wc*src[y,x] + wn*(src[y-1,x] + src[y+1,x] + src[y,x-1] + src[y,x+1])
//
// `src` is the (Y+2, X+2) halo-padded field, `dst` is (Y, X), both
// contiguous.  The weights arrive as doubles and are rounded to T before
// they multiply (JAX's weak typing does the same); the neighbours are summed
// up, down, left, right, left to right, as ref.py sums them, so the only
// difference to the plain version is FMA contraction.
//
// Both kernels are bound by DRAM bytes on the H100: the bound counts each
// padded element the star reads once and each output written once; 5 flops
// a point are far below the rate.  At X = 4096 the fp32 padded row is
// 16,392 bytes, not a multiple of 16, so rows alternate between 16- and
// 8-byte alignment: the TMA unit's bulk copies, which need 16-byte aligned
// rows, do not take that field.
//
// jacobi_pointwise
//   Replaces the TPU kernel repro/kernels/jacobi2d/kernel.py:make_rowstream
//   (grid Y, three padded rows streamed per output row).  It is the kernel
//   the analytical GPU model prices (core.specs.stencil_2d5pt): one thread
//   per (point x fold iteration) with exactly the
//   repro_torch/core/gridwalk.py:block_points mapping on the domain
//   (1, Y, X) — blockDim = (bx, by, bz), gridDim = LaunchConfig.grid_for,
//   thread (tx,ty,tz) of block (bx,by,bz) computes
//   (bz*ez + tz*fz + jz, by*ey + ty*fy + jy, bx*ex + tx*fx + jx), fold loops
//   jz outer .. jx inner.  The domain has depth 1, so a thread with
//   tz*fz + jz >= 1 has no point and leaves at the guard: a launch with
//   bz > 1 keeps only its tz = 0 threads busy, which the GPU model does not
//   price (it is the reference's model, reproduced as it is).  The re-reads
//   of each element by its neighbours are left to L1 and L2, as the
//   estimator models it.  The priced stream stays as it is; the design
//   changes what lies around it:
//   * compile-time folds for the priced launches (fx = 1, fy = 1 or 2; on
//     the depth-1 domain only a thread whose first z is 0 has points, so fz
//     drops out), one generic instantiation for any other fold; the runtime
//     fold loops measured 23-33 % slower in fp32 (PERF.md);
//   * at fy = 2 the column's rows y-1 .. y+2 are loaded once: 8 loads for
//     the two points, not 10, all issued before the arithmetic, both stores
//     after it;
//   * 64-bit element offsets (PointOffset), in every instantiation: 32-bit
//     ones measured within 1 % of them and would need a second
//     instantiation for fields past 2^31 padded elements;
//   * __launch_bounds__(1024) and no minimum block count: ptxas stays at
//     32 registers or fewer without one, so the ranked 1024-thread launch
//     keeps two CTAs, 2048 threads, on every SM;
//   * plain loads and stores: ld.global.nc and st.global.cs (kCacheHints)
//     measured within 1 % of them.
//
// jacobi_ytile
//   Replaces make_ytile(ty) (grid Y/ty; padded tiles j and j+1 concatenated
//   in VMEM give ty output rows).  The TPU walks its grid in order; here a
//   persistent grid of CTAs (two an SM) each takes an equal, contiguous
//   range of the (strip, y-tile) steps, strip-major: a strip is tx output
//   columns, a y-tile ty rows, so a CTA marches down y through one strip (or
//   the end of one and the start of the next).  The CTA count is a multiple
//   of the strips, so that the CTAs of one y-range work their strips side by
//   side.
//   * A producer warp streams the padded rows of its strip, tx + 2 columns
//     wide, into a ring of S slots in shared memory, each slot `rows` padded
//     rows (ty where S such slots fit two CTAs an SM, else fewer), with a
//     full and an empty mbarrier a slot, and runs up to S slots ahead.  A
//     slot row keeps its field row's address modulo 16 (the slot rows are a
//     pitch apart that is congruent to the field's), so the producer copies
//     whole 16-byte pieces whatever the field's row pitch.  Route "tma" (the
//     wrapper's ytile_route: rows, strip starts and the field 16-byte
//     aligned): one bulk copy of the TMA unit a row, counted on the full
//     barrier in bytes.  Route "cp_async" (any other field, fp32 at
//     X = 4096 among them): the warp's lanes copy the 16-byte pieces around
//     each row by cp.async, and each lane's cp.async.mbarrier.arrive lands
//     on the full barrier once its copies have.  Copies of 8 bytes, the
//     widest the unshifted rows allowed, measured 10 % slower in fp32.
//   * Each input row is read from device memory once per strip and range:
//     the y halo once per range, not once per tile, the x halo at
//     (tx + 2) / tx.
//   * The consumers, one thread two adjacent output columns where the
//     strips, X and the field's address keep every pair aligned
//     (kernel.ytile_columns; else one), march down their columns a slot at
//     a time: a row's taps are read once, as the row below the centre, in
//     pairs of 8 (fp32) or 16 (fp64) bytes, and ride in registers as the
//     centre and then the up taps; the outputs are stored in pairs too; no
//     index is divided.  A slot goes back to the producer once the first
//     row of the next has been read.
//   * The edges are masked, so the input needs no padding beyond its halo
//     of 1.  Every tile runs: one that the ring of ty-row slots does not fit
//     takes slots of fewer rows.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

// design switches that kernels/jacobi2d/ablate.py flips, one at a time
constexpr bool kFoldInstances = true;  // compile-time folds for the priced launches
using PointOffset = int64_t;           // jacobi_pointwise's element offsets
// true: jacobi_pointwise loads by ld.global.nc and both kernels store by
// st.global.cs (evict first); false: plain loads and stores
constexpr bool kCacheHints = false;
// false: jacobi_ytile's producer waits for each slot's copies to land, and
// for the consumers to finish the slot before it, before it issues the next
constexpr bool kAsyncRing = true;
// false: jacobi_ytile's consumers read the up and centre taps from shared
// memory for every output, not from the registers of the rows before (the
// up taps of a slot's second centre row still come from registers: the slot
// that held them has gone back to the producer)
constexpr bool kYTapsInRegisters = true;

constexpr int kRouteTma = 0;
constexpr int kRouteCpAsync = 1;
constexpr int kMaxTx = 256;                   // consumers of a CTA, one or two columns each
constexpr int kYtileMaxThreads = 32 + kMaxTx;  // the producer warp and the consumers
constexpr int kMaxStages = 8;

template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kCacheHints) return __ldg(p);
  else return *p;
}

template <typename T>
__device__ __forceinline__ void st(T* p, T v) {
  if constexpr (kCacheHints) __stcs(p, v);
  else *p = v;
}

template <typename T>
__device__ __forceinline__ T sweep(T c, T u, T d, T l, T r, T wc, T wn) {
  return wc * c + wn * (u + d + l + r);
}

// FY > 0: fx = 1 and fy = FY at compile time; FY = 0: the folds from the
// arguments
template <typename T, int FY>
__global__ void __launch_bounds__(1024)
jacobi_pointwise_kernel(const T* __restrict__ src, T* __restrict__ dst,
                        double wc_arg, double wn_arg, int Y, int X, int fx_arg,
                        int fy_arg, int fz) {
  const T wc = static_cast<T>(wc_arg);
  const T wn = static_cast<T>(wn_arg);
  const PointOffset Xp = X + 2;
  const int fx = FY > 0 ? 1 : fx_arg;
  const int fy = FY > 0 ? FY : fy_arg;
  const int x0 = blockIdx.x * (blockDim.x * fx) + threadIdx.x * fx;
  const int y0 = blockIdx.y * (blockDim.y * fy) + threadIdx.y * fy;
  const int z0 = blockIdx.z * (blockDim.z * fz) + threadIdx.z * fz;
  if constexpr (FY > 0) {
    // the domain (1, Y, X) has one plane: a thread has points only if its
    // first z (fold jz = 0) is plane 0
    if (z0 != 0 || x0 >= X || y0 >= Y) return;
    const T* c = src + ((PointOffset)(y0 + 1) * Xp + (x0 + 1));
    T* o = dst + ((PointOffset)y0 * X + x0);
    if constexpr (FY == 1) {
      const T u = ld(c - Xp), m = ld(c), d = ld(c + Xp), l = ld(c - 1), r = ld(c + 1);
      st(o, sweep(m, u, d, l, r, wc, wn));
    } else {
      // padded rows y0 .. y0+3 of the column, then each centre row's sides
      const bool two = y0 + 1 < Y;
      const T a0 = ld(c - Xp), a1 = ld(c), a2 = ld(c + Xp);
      const T l0 = ld(c - 1), r0 = ld(c + 1);
      T a3 = T(0), l1 = T(0), r1 = T(0);
      if (two) {
        a3 = ld(c + 2 * Xp);
        l1 = ld(c + Xp - 1);
        r1 = ld(c + Xp + 1);
      }
      const T o0 = sweep(a1, a0, a2, l0, r0, wc, wn);
      const T o1 = sweep(a2, a1, a3, l1, r1, wc, wn);
      st(o, o0);
      if (two) st(o + X, o1);
    }
  } else {
    for (int jz = 0; jz < fz; ++jz) {
      if (z0 + jz >= 1) break;  // the domain (1, Y, X) has one plane
      for (int jy = 0; jy < fy; ++jy) {
        const int y = y0 + jy;
        if (y >= Y) break;
        for (int jx = 0; jx < fx; ++jx) {
          const int x = x0 + jx;
          if (x >= X) break;
          const T* c = src + ((PointOffset)(y + 1) * Xp + (x + 1));
          const T u = ld(c - Xp), m = ld(c), d = ld(c + Xp), l = ld(c - 1), r = ld(c + 1);
          st(dst + ((PointOffset)y * X + x), sweep(m, u, d, l, r, wc, wn));
        }
      }
    }
  }
}

// jacobi_ytile's geometry, from the wrapper (kernel.ytile_plan, ytile_route)
struct YtileArgs {
  int Y, X;    // output domain
  int ty, tx;  // a y-tile's rows, a strip's output columns
  int rows;    // padded rows of a ring slot
  int pitch;   // bytes from one slot row to the next (kernel.ytile_row_bytes)
  int stages;  // S
  int route;   // kRouteTma or kRouteCpAsync
  int columns; // output columns a consumer thread owns, 1 or 2
};

// 16 (or N < 16) bytes by cp.async.  16-byte copies skip L1 (.cg).
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(N)
                 : "memory");
}

// one arrival on `bar` once every earlier cp.async of this thread has landed
// (.noinc: the barrier's count already holds it)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Where a slot's padded rows lie: a row whose first element is at global
// address A sits at a shared address congruent to A modulo 16 (slot rows are
// a pitch apart that is congruent to the field's row pitch, and the slot's
// first row starts 16 + A mod 16 bytes into the slot), so that whole 16-byte
// pieces of the field land as whole 16-byte pieces of the slot, whatever the
// field's row pitch.  The bytes a row copies beyond its own fall into the gap
// before the next row, which nothing reads.
__device__ __forceinline__ int slot_head(const void* row) {
  return 16 + (int)(reinterpret_cast<uintptr_t>(row) & 15);
}

// The producer lanes' 16-byte cp.async copies of `nr` padded rows from `row0`
// (rows `xp` elements apart), each the whole 16-byte pieces around its `len`
// bytes, into the slot at `slot` (its rows `pitch` bytes apart).  Only the
// field's first and last rows can have a piece that reaches outside the
// field [lo, hi); theirs are copied element by element, inside it.
template <typename T>
__device__ __forceinline__ void fill_cp_async(uint32_t slot, const T* row0, int64_t xp, int nr,
                                              int len, int pitch, const T* lo, const T* hi,
                                              int lane) {
  uint32_t dst = slot + slot_head(row0);
  for (int r = 0; r < nr; ++r, row0 += xp, dst += pitch) {
    const int head = (int)(reinterpret_cast<uintptr_t>(row0) & 15);
    const int pieces = (head + len + 15) >> 4;
    const char* g = reinterpret_cast<const char*>(row0) - head;
    const uint32_t d = dst - head;
    if (g >= reinterpret_cast<const char*>(lo) &&
        g + 16 * pieces <= reinterpret_cast<const char*>(hi)) {
      for (int k = lane; k < pieces; k += 32) cp_async<16>(d + 16 * k, g + 16 * k);
      continue;
    }
    for (int e = lane * (int)sizeof(T); e < 16 * pieces; e += 32 * (int)sizeof(T))
      if (g + e >= reinterpret_cast<const char*>(lo) && g + e < reinterpret_cast<const char*>(hi))
        cp_async<sizeof(T)>(d + e, g + e);
  }
}

// A slot of the ring: its index and the phase of its mbarriers, stepped
// without a division
struct RingPos {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The V + 2 taps of a row around a thread's V output columns, from p: in
// pairs where V = 2 (8 or 16 bytes, aligned as kernel.ytile_columns asks)
template <int V, typename T>
__device__ __forceinline__ void load_taps(T (&v)[V + 2], const T* p) {
  if constexpr (V == 2) {
    using T2 = std::conditional_t<sizeof(T) == 4, float2, double2>;
    const T2 lo = *reinterpret_cast<const T2*>(p);
    const T2 hi = *reinterpret_cast<const T2*>(p + 2);
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  } else {
#pragma unroll
    for (int i = 0; i < V + 2; ++i) v[i] = p[i];
  }
}

// A thread's V outputs at o: one store of a pair where V = 2
template <int V, typename T>
__device__ __forceinline__ void store_outputs(T* o, const T (&v)[V]) {
  if constexpr (V == 2) {
    using T2 = std::conditional_t<sizeof(T) == 4, float2, double2>;
    T2 pair;
    pair.x = v[0];
    pair.y = v[1];
    st(reinterpret_cast<T2*>(o), pair);
  } else {
    st(o, v[0]);
  }
}

// V: output columns a consumer thread owns (kernel.ytile_columns)
template <typename T, int V>
__global__ void __launch_bounds__(kYtileMaxThreads)
jacobi_ytile_kernel(const T* __restrict__ src, T* __restrict__ dst, double wc_arg,
                    double wn_arg, const YtileArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = a.rows, S = a.stages, P = a.pitch, tx = a.tx;
  // the rows and room for the first row's head piece and the last row's tail,
  // 16-byte aligned
  const int slot_bytes = ((R * P + 15) & ~15) + 32;
  const int bw = P / (int)sizeof(T);  // elements from one slot row to the next
  const bool tma = a.route == kRouteTma;
  // each slot's full and empty mbarriers, after the ring
  const uint32_t bars = smem_u32(smem_raw + (size_t)S * slot_bytes);
  auto full = [&](const RingPos& p) { return bars + 8u * p.slot; };
  auto empty = [&](const RingPos& p) { return bars + 8u * (S + p.slot); };
  auto slot = [&](const RingPos& p) { return smem_raw + (size_t)p.slot * slot_bytes; };
  if (threadIdx.x == 0) {
    for (RingPos p; p.phase == 0; p.next(S)) {
      mbar_init(full(p), tma ? 1 : 32);              // expect_tx, or each lane's cp.async
      mbar_init(empty(p), (blockDim.x - 32) / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t Xp = a.X + 2;
  const int tiles_y = (a.Y + a.ty - 1) / a.ty;
  const int steps = (a.X + tx - 1) / tx * tiles_y;
  // this CTA's equal, contiguous range of the (strip, y-tile) steps, strip-major
  const int begin = (int)((int64_t)blockIdx.x * steps / gridDim.x);
  const int end = (int)((int64_t)(blockIdx.x + 1) * steps / gridDim.x);
  // the segment of the range that starts at step s: outputs y0 .. y0+n-1 of
  // the strip at x0, from padded rows y0 .. y0+n+1; returns its steps
  auto segment = [&](int s, int& x0, int& y0, int& n) {
    const int strip = s / tiles_y;
    const int t = s - strip * tiles_y;
    const int cnt = min(tiles_y - t, end - s);
    x0 = strip * tx;
    y0 = t * a.ty;
    n = min(a.Y, (t + cnt) * a.ty) - y0;
    return cnt;
  };
  const int lane = threadIdx.x & 31;

  if (threadIdx.x < 32) {  // the producer warp
    const T* lo = src;
    const T* hi = src + (a.Y + 2) * Xp;
    RingPos w, before;  // the slot it fills, and the one filled before
    for (int s = begin, k = 0; s < end;) {
      int x0, y0, n;
      s += segment(s, x0, y0, n);
      const int cols = (int)min((int64_t)tx + 2, Xp - x0);  // the strip's padded columns
      const T* row0 = src + (int64_t)y0 * Xp + x0;
      for (int q = 0; q < n + 2; q += R, row0 += R * Xp, ++k) {
        if (k >= S) mbar_wait(empty(w), w.phase ^ 1);
        const int nr = min(R, n + 2 - q);
        const uint32_t d = smem_u32(slot(w));
        if (tma) {
          // rows, strip starts and the field 16-byte aligned: one bulk copy a
          // row of whole 16-byte pieces, no further than the row's end
          const uint32_t bytes = (uint32_t)min((cols * (int64_t)sizeof(T) + 15) & ~15,
                                               (Xp - x0) * (int64_t)sizeof(T));
          if (lane == 0) mbar_arrive_expect_tx(full(w), nr * bytes);
          __syncwarp();
          for (int r = lane; r < nr; r += 32)
            bulk_load(d + slot_head(row0) + r * P, row0 + r * Xp, bytes, full(w));
        } else {
          fill_cp_async(d, row0, Xp, nr, cols * (int)sizeof(T), P, lo, hi, lane);
          cp_async_arrive(full(w));
        }
        if constexpr (!kAsyncRing) {
          mbar_wait(full(w), w.phase);
          if (k >= 1) mbar_wait(empty(before), before.phase);
        }
        before = w;
        w.next(S);
      }
    }
    return;
  }

  // the consumers: thread c < ceil(tx / V) owns output columns x0 + V c ..
  // x0 + V c + V - 1 of its strip; the last warp's threads past them read the
  // last thread's taps and store nothing.  A slot row's element j is padded
  // column x0 + j, so a thread's taps in a row are its elements V c .. V c + V + 1.
  const int nc = (tx + V - 1) / V;
  const int c = min((int)threadIdx.x - 32, nc - 1);
  const bool owner = (int)threadIdx.x - 32 < nc;
  const T wc = static_cast<T>(wc_arg);
  const T wn = static_cast<T>(wn_arg);
  auto release = [&](const RingPos& p) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(p));
  };
  RingPos rd;  // the next slot to read
  for (int s = begin; s < end;) {
    int x0, y0, n;
    s += segment(s, x0, y0, n);
    const bool live = owner && x0 + V * c < a.X;
    T* o = dst + (int64_t)y0 * a.X + x0 + V * c;
    const T* row0 = src + (int64_t)y0 * Xp + x0;  // the first padded row of the next slot
    // this thread's taps in the slot at p, whose first row is at row0
    auto taps = [&](const RingPos& p) {
      return reinterpret_cast<const T*>(slot(p) + slot_head(row0)) + V * c;
    };
    T up[V], cen[V + 2];  // the taps of the two rows above the next row to arrive
    // the outputs whose centre row is `row` (its taps in cen, the up taps in
    // up) and whose down row is `down`; `above` is the up row where it is
    // still in the ring, else null
    auto emit = [&](const T* above, const T* row, const T* down) {
      if constexpr (!kYTapsInRegisters) {
        load_taps<V>(cen, row);
        if (above) {
#pragma unroll
          for (int i = 0; i < V; ++i) up[i] = above[i + 1];
        }
      }
      T dn[V + 2], out[V];
      load_taps<V>(dn, down);
#pragma unroll
      for (int i = 0; i < V; ++i)
        out[i] = sweep(cen[i + 1], up[i], dn[i + 1], cen[i], cen[i + 2], wc, wn);
      if (live) store_outputs<V>(o, out);
      o += a.X;
#pragma unroll
      for (int i = 0; i < V; ++i) up[i] = cen[i + 1];
#pragma unroll
      for (int i = 0; i < V + 2; ++i) cen[i] = dn[i];
    };
    // slot 0: padded rows y0 and y0 + 1 (R >= 2) arrive as up and centre
    mbar_wait(full(rd), rd.phase);
    const T* cur = taps(rd);
#pragma unroll
    for (int i = 0; i < V; ++i) up[i] = cur[i + 1];
    load_taps<V>(cen, cur + bw);
    int nr = min(R, n + 2);
#pragma unroll 4
    for (int r = 2; r < nr; ++r) emit(cur + (r - 2) * bw, cur + (r - 1) * bw, cur + r * bw);
    for (int q = R; q < n + 2; q += R) {
      // the next slot: its first row is the down of the last row before it
      const RingPos held = rd;
      rd.next(S);
      row0 += R * Xp;
      mbar_wait(full(rd), rd.phase);
      const T* prev = cur;
      cur = taps(rd);
      nr = min(R, n + 2 - q);
      emit(prev + (R - 2) * bw, prev + (R - 1) * bw, cur);
      release(held);
      if (nr > 1) emit(nullptr, cur, cur + bw);
#pragma unroll 4
      for (int r = 2; r < nr; ++r) emit(cur + (r - 2) * bw, cur + (r - 1) * bw, cur + r * bw);
    }
    release(rd);
    rd.next(S);
  }
}

template <typename T, int FY>
int go_pointwise(const void* src, void* dst, double wc, double wn, int Y, int X, int bx,
                 int by, int bz, int fx, int fy, int fz, cudaStream_t stream) {
  const int ex = bx * fx, ey = by * fy, ez = bz * fz;
  const dim3 grid((X + ex - 1) / ex, (Y + ey - 1) / ey, (1 + ez - 1) / ez);
  jacobi_pointwise_kernel<T, FY><<<grid, dim3(bx, by, bz), 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), wc, wn, Y, X, fx, fy, fz);
  return (int)cudaGetLastError();
}

// the folds of the priced launches (fx 1, fy 1 or 2) unrolled, any other the
// generic kernel
template <typename T>
int launch_pointwise(const void* src, void* dst, double wc, double wn, int Y, int X, int bx,
                     int by, int bz, int fx, int fy, int fz, cudaStream_t s) {
  if (kFoldInstances && fx == 1 && fy == 1)
    return go_pointwise<T, 1>(src, dst, wc, wn, Y, X, bx, by, bz, fx, fy, fz, s);
  if (kFoldInstances && fx == 1 && fy == 2)
    return go_pointwise<T, 2>(src, dst, wc, wn, Y, X, bx, by, bz, fx, fy, fz, s);
  return go_pointwise<T, 0>(src, dst, wc, wn, Y, X, bx, by, bz, fx, fy, fz, s);
}

// the ring's slots (as the kernel lays them out) and two mbarriers a slot
size_t ytile_smem(const YtileArgs& a) {
  return (size_t)a.stages * ((((size_t)a.rows * a.pitch + 15) & ~(size_t)15) + 32 + 16);
}

template <typename T, int V>
int launch_ytile(const void* src, void* dst, double wc, double wn, const YtileArgs& a, int ctas,
                 cudaStream_t stream) {
  const size_t smem = ytile_smem(a);
  const cudaError_t e = cudaFuncSetAttribute(
      jacobi_ytile_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = 32 + ((a.tx + V - 1) / V + 31) / 32 * 32;
  jacobi_ytile_kernel<T, V><<<ctas, threads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), wc, wn, a);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int blocks_per_sm(int threads, int smem) {
  cudaError_t e = cudaFuncSetAttribute(jacobi_ytile_kernel<T, V>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, jacobi_ytile_kernel<T, V>, threads,
                                                      smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

// elem_bytes selects float (4) or double (8); any other returns
// cudaErrorInvalidValue without launching.
int jacobi_pointwise_launch(int elem_bytes, const void* src, void* dst, double wc, double wn,
                            int Y, int X, int bx, int by, int bz, int fx, int fy, int fz,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 8)
    return launch_pointwise<double>(src, dst, wc, wn, Y, X, bx, by, bz, fx, fy, fz, s);
  if (elem_bytes == 4)
    return launch_pointwise<float>(src, dst, wc, wn, Y, X, bx, by, bz, fx, fy, fz, s);
  return (int)cudaErrorInvalidValue;
}

// The geometry (rows, pitch, stages, route) comes from kernel.ytile_plan,
// ytile_row_bytes and ytile_route.  What would let the kernel read or write
// outside its buffers, or copy from an address its route cannot, returns
// cudaErrorInvalidValue without launching.
int jacobi_ytile_launch(int elem_bytes, const void* src, void* dst, double wc, double wn, int Y,
                        int X, int ty, int tx, int rows, int pitch, int stages, int route,
                        int columns, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t steps = Y < 1 || X < 1 || ty < 1 || tx < 1
                            ? 0
                            : (int64_t)((X + tx - 1) / tx) * ((Y + ty - 1) / ty);
  const int64_t row_bytes = ((int64_t)X + 2) * elem_bytes;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const bool ok =
      (elem_bytes == 4 || elem_bytes == 8) && steps >= 1 && steps < INT32_MAX &&
      (int64_t)Y + 2 < INT32_MAX && (columns == 2 ? (tx + 1) / 2 : tx) <= kMaxTx && rows >= 2 &&
      (int64_t)pitch >= ((int64_t)tx + 2) * elem_bytes + 16 && pitch % elem_bytes == 0 &&
      (pitch - row_bytes) % 16 == 0 && stages >= 2 && stages <= kMaxStages && ctas >= 1 &&
      ctas <= steps && addr % elem_bytes == 0 &&
      (route == kRouteCpAsync ||
       (route == kRouteTma && row_bytes % 16 == 0 && (tx * elem_bytes) % 16 == 0 &&
        addr % 16 == 0)) &&
      (columns == 1 ||
       (columns == 2 && tx % 2 == 0 && X % 2 == 0 && addr % (2 * elem_bytes) == 0 &&
        reinterpret_cast<uintptr_t>(dst) % (2 * elem_bytes) == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const YtileArgs a = {Y, X, ty, tx, rows, pitch, stages, route, columns};
  if (ytile_smem(a) > 232448) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 8)
    return columns == 2 ? launch_ytile<double, 2>(src, dst, wc, wn, a, ctas, s)
                        : launch_ytile<double, 1>(src, dst, wc, wn, a, ctas, s);
  return columns == 2 ? launch_ytile<float, 2>(src, dst, wc, wn, a, ctas, s)
                      : launch_ytile<float, 1>(src, dst, wc, wn, a, ctas, s);
}

// CTAs of the y-tile kernel with `columns` output columns a consumer one SM
// holds at once with `threads` threads and `smem` bytes of dynamic shared
// memory, or minus a CUDA error
int jacobi_ytile_blocks_per_sm(int elem_bytes, int columns, int threads, int smem) {
  if (columns != 1 && columns != 2) return -(int)cudaErrorInvalidValue;
  if (elem_bytes == 8)
    return columns == 2 ? blocks_per_sm<double, 2>(threads, smem)
                        : blocks_per_sm<double, 1>(threads, smem);
  if (elem_bytes == 4)
    return columns == 2 ? blocks_per_sm<float, 2>(threads, smem)
                        : blocks_per_sm<float, 1>(threads, smem);
  return -(int)cudaErrorInvalidValue;
}

const char* jacobi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
