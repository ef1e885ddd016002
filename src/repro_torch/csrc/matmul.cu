// Hand-written Hopper (sm_90a) GEMM kernels
//
//   C = A · B,   A (M, K), B (K, N), C (M, N), all row-major and contiguous,
//   accumulated in fp32 and cast to the output dtype (the inputs' dtype).
//
// matmul_tiled
//   Replaces the TPU kernel repro/kernels/matmul/kernel.py:
//   make_matmul(M, K, N, bm, bk, bn) (grid (M/bm, N/bn, K/bk), k innermost,
//   an f32 VMEM accumulator written once at the last k step).  The TPU's
//   sequential k axis becomes a loop inside the CTA over BK-deep slabs, the
//   f32 accumulator stays in registers, and the CTA tiles are this kernel's
//   own (instantiated below): the TPU's 128..1024 VMEM blocks do not fit.
//
//   bf16: bound by the tensor cores at the model's shapes (989 TFLOP/s
//   dense bf16; a 16384 x 2048 x 3072 GEMM does ~1400 flops a byte, far
//   above the H100's ridge of ~295), and only wgmma reaches their full
//   rate.  So the kernel is Hopper's own shape: one CTA of three
//   warpgroups per SM, persistent over the output tiles.
//   - Warpgroup 0 is the producer: one thread issues TMA copies of a
//     (BM x 64) A slab and a (64 x BN) B slab (BN/64 boxes 64 wide) into a
//     ring of stages in shared memory, 128-byte swizzled; a "full" mbarrier
//     per stage carries the transaction bytes, an "empty" one is signalled
//     by the consumers.  It drops to 40 registers (setmaxnreg).
//   - Warpgroups 1 and 2 are consumers, one per 64-row half of the tile:
//     wgmma.mma_async m64nBNk16 straight from shared memory (A K-major, B
//     MN-major through the transpose-B mode, so B is never transposed in
//     memory), the accumulator in BN/2 fp32 registers a thread (232 by
//     setmaxnreg).  One wgmma group stays in flight: a stage is released
//     once wgmma.wait_group shows that the slab before it has been read.
//   - The tiles are walked in a grouped raster (GROUP_M tile rows at a
//     time), so the tiles in flight on the 132 SMs share A rows and B
//     columns in the 50 MB L2.  While the consumers round one tile, the
//     producer already fills the ring for the next.
//   - The epilogue rounds the fp32 accumulator to bf16 once, into two
//     swizzled 64 x 64 buffers per consumer in shared memory, and TMA
//     stores each chunk, asynchronously, so the next tile's wgmmas start
//     at once (scattered 4-byte stores from registers kept the tensor
//     cores idle at every tile's end).
//   Edges: TMA zero-fills what lies outside the tensors (a ragged M or N,
//   the K tail) on loads and clips it on stores.  TMA needs 16-byte global
//   strides and a 16-byte-aligned base: K and N multiples of 8 and aligned
//   operands (the wrapper checks both).  The tensor maps are encoded on the
//   host at each call (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPointByVersion, so nothing links against libcuda;
//   CUDA 12.5 or later) and passed as __grid_constant__ parameters.
//
//   fp32: bound by the tensor cores too, once they take it.  The CUDA
//   cores' fp32 rate is 67 TFLOP/s; the TF32 tensor cores run 494.7
//   (dense, H100 SXM data sheet), but one TF32 pass keeps 11 of the 24
//   significant bits of each operand.  So the product is taken in three
//   TF32 passes ("3xTF32"): each operand x splits into hi = tf32(x) and
//   lo = tf32(x - hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi is summed in
//   fp32; the dropped a_lo b_lo and the rounding of the lo parts are about
//   2^-22 of each product, below fp32's own summation error over K.  The
//   least time is that of three TF32 products (0.8335 ms at the 16384 x
//   2048 x 2048 GEMM, 2.5x under the CUDA cores' 2.0513 ms).
//   - matmul_split_b_kernel: TF32 wgmma takes both operands K-major (it
//     has no transpose mode), so B (K, N) is read once and written as B^T
//     split into two (N, K) arrays, hi and lo, through a shared tile (both
//     sides coalesced): 2 x 16 MB at that GEMM.
//   - matmul_split_tf32_kernel: the bf16 kernel's shape.  Persistent
//     CTAs walk the tiles in the grouped raster; a producer warp keeps a
//     TMA ring full, each stage a (BM x 32) slab of A (raw fp32, 128-byte
//     rows and swizzle) and a (BN x 32) slab of B_hi and of B_lo; two
//     consumer warpgroups, 64 rows each, read their A fragments by
//     ldmatrix through the swizzle, split them in registers (cvt.rna.tf32)
//     once a slab, and issue wgmma m64n128k8 .tf32 with A from registers,
//     the small terms first.  A is read from device memory once and split
//     once a slab, not once a pass.  The tensor cores' fp32 sums do not
//     round to nearest, so (kPromote) each slab is summed in a second
//     accumulator and added into the tile's on the CUDA cores; the two
//     accumulators fix the tile at 128 x 128 x 32, 4 stages.  The
//     epilogue stores fp32 through swizzled shared buffers with TMA.
//   Measured at that GEMM (kernels/matmul/ablate.py --part fp32, H100 SXM,
//   700 W): 1.02 ms, 82 % of the bound, against 2.89 ms for torch.matmul
//   with TF32 off, with 0.24x its RMS error against an fp64 product.  A
//   one-pass probe takes 0.56 ms, as long as torch.matmul's own one TF32
//   pass: three passes cost 1.8x one.
//   Edges as in bf16: TMA zero-fills the loads (ragged M and N, the K
//   tail) and clips the stores; the 16-byte strides need K and N
//   multiples of 4.
//
//   The fp32 CUDA-core kernel that the split route replaced stays as the
//   ablation's comparator (matmul_tiled_launch with elem_bytes 4 and tile
//   128 x 128 x 16): 256 threads as 16 x 16, each owning TM x TN outputs in
//   groups of 4 at a stride of 64 (conflict-free float4 reads of shared
//   memory), A transposed in shared memory, the next slab loaded into
//   registers while the current one is multiplied; masked edges; K and N
//   multiples of 4.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch
// (or a negative code of its own, see matmul_error_string).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// d (64 x 256 fp32 fragment, 128 registers a thread) += A (smem) * B (smem);
// A K-major, B MN-major (imm-trans-b = 1), scale-d 0 overwrites d
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 fp32 fragment, 64 registers a thread) += A (smem) * B (smem);
// A K-major, B MN-major (imm-trans-b = 1), scale-d 0 overwrites d
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BN == 256)
    wgmma_n256(d, da, db, scale_d);
  else
    wgmma_n128(d, da, db, scale_d);
}

constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = 3 * kWgThreads;  // producer + two consumer warpgroups
constexpr int kBM = 128;                       // two 64-row consumer halves
constexpr int kBK = 64;                        // one 128-byte swizzle row of bf16
constexpr int kBox = 64;                       // B box width (128 bytes of bf16)
constexpr int kGroupM = 8;                     // tile rows of one raster group
constexpr int kCBytes = 64 * kBox * 2;         // one 64 x 64 epilogue chunk of C
constexpr int kSmemLimit = 232448;             // dynamic shared memory a CTA may opt into

template <int BN>
struct WgmmaTile {
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kEpiBytes = 2 * 2 * kCBytes;  // two chunk buffers per consumer
  static constexpr int kStages = (kSmemLimit - 2048 - kEpiBytes) / kStageBytes;
  // the stages, the epilogue's buffers, 1024 bytes of slack to align them
  // to the swizzle's 1024-byte period, and a full and an empty mbarrier
  // per stage
  static constexpr int kSmem = kStages * kStageBytes + kEpiBytes + 1024 + 2 * kStages * 8;
  static_assert(BN == 128 || BN == 256, "wgmma tile width");
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "shared memory");
};

// tile t of the grouped raster -> (tile row, tile column)
__device__ __forceinline__ void tile_coords(int t, int m_tiles, int n_tiles, int& mt, int& nt) {
  const int per_group = kGroupM * n_tiles;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(m_tiles - first, kGroupM);
  mt = first + (t % per_group) % rows;
  nt = (t % per_group) / rows;
}

template <int BN>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b,
                    const __grid_constant__ CUtensorMap tma_c, int M, int N, int K) {
  using T = WgmmaTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sa = base;                               // [stages][BM][64], swizzled
  const uint32_t sb = base + T::kStages * T::kABytes;     // [stages][BN/64][64][64], swizzled
  const uint32_t sc = sb + T::kStages * T::kBBytes;       // [2 consumers][2][64][64], swizzled
  const uint32_t bars = sc + T::kEpiBytes;                // full[stages], empty[stages]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (T::kStages + s); };

  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int ktiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full(s), 1);   // the producer's arrive.expect_tx
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else on the warpgroup for the whole kernel: the roles never
  // reconverge, so setmaxnreg takes effect
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        tile_coords(t, m_tiles, n_tiles, mt, nt);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % T::kStages;
          mbar_wait(empty(s), ((it / T::kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), T::kStageBytes);
          tma_load_2d(sa + s * T::kABytes, &tma_a, kt * kBK, mt * kBM, full(s));
#pragma unroll
          for (int j = 0; j < BN / kBox; ++j)
            tma_load_2d(sb + s * T::kBBytes + j * kBK * kBox * 2, &tma_b, nt * BN + j * kBox,
                        kt * kBK, full(s));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1;  // rows 64*half .. 64*half+63 of the tile
    const int warp = tid / 32, lane = tid % 32;
    float acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, nt;
      tile_coords(t, m_tiles, n_tiles, mt, nt);
      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % T::kStages;
        mbar_wait(full(s), (it / T::kStages) & 1);
        // A: K-major, 8-row groups 1024 bytes apart; a k16 step is 32
        // bytes along the swizzled row.  B: MN-major, 64-wide boxes
        // 8 KB apart (leading offset), 8-row k groups 1024 bytes apart;
        // a k16 step is 16 rows, 2048 bytes.
        const uint32_t a0 = sa + s * T::kABytes + half * 64 * kBK * 2;
        const uint32_t b0 = sb + s * T::kBBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_tile<BN>(acc, smem_desc(a0 + kk * 32, 16, 1024),
                         smem_desc(b0 + kk * 16 * kBox * 2, kBK * kBox * 2, 1024),
                         (kt > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // the slab before this one has been read
        if (kt > 0 && tid == 0) mbar_arrive(empty(prev));
        prev = s;
      }
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(empty(prev));

      // the epilogue, in 64-column chunks through two swizzled buffers:
      // round to bf16 into shared memory, then one TMA store per chunk,
      // which clips what lies outside C and runs on while the next tile
      // is multiplied.  Register 4j+e of the m64nBN fragment holds row
      // 16*warp + lane/4 (+8 for e >= 2), column 8j + 2*(lane%4) + (e & 1).
      const int r = warp * 16 + lane / 4;
#pragma unroll
      for (int c = 0; c < BN / kBox; ++c) {
        const uint32_t buf = sc + (half * 2 + (c & 1)) * kCBytes;
        if (tid == 0) tma_store_wait_read<1>();  // the store that last read buf is done
        warpgroup_sync(1 + half);
#pragma unroll
        for (int jj = 0; jj < kBox / 8; ++jj) {
          const int j = c * (kBox / 8) + jj;
          // 128-byte swizzle: 16-byte unit jj of row r sits at unit jj ^ (r % 8)
          const uint32_t off = r * 128 + ((jj ^ (r & 7)) << 4) + (lane % 4) * 4;
          *reinterpret_cast<__nv_bfloat162*>(smem_raw + (buf - raw) + off) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(smem_raw + (buf - raw) + off + 8 * 128) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
        fence_async_shared();
        warpgroup_sync(1 + half);
        if (tid == 0) tma_store_2d(&tma_c, buf, nt * BN + c * kBox, mt * kBM + half * 64);
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

// ---------------------------------------------------------------------------
// fp32: three TF32 passes on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kSplitBK = 32;                      // one 128-byte swizzle row of fp32
constexpr int kSplitBox = 32;                     // C chunk width (128 bytes of fp32)
constexpr int kSplitCBytes = 64 * kSplitBox * 4;  // one 64 x 32 epilogue chunk of C
constexpr int kSplitT = 32;                       // the B split pass's square tile
// 3: lo*B_hi + hi*B_lo + hi*B_hi; 1: hi*B_hi alone (a one-pass TF32 product)
constexpr int kPasses = 3;
// each 32-deep slab summed in a second accumulator, then added into the
// tile's in fp32 on the CUDA cores: the tensor cores' own sums do not round
// to nearest (summed straight, the out GEMM's RMS error against fp64 reads
// 17.6x torch.matmul's, 0.24x with slab sums).  The two accumulators take
// 128 registers a thread, so the tile is 128 wide: a 256-wide one has no
// room for the second
constexpr bool kPromote = true;
constexpr int kSplitBN = 128;

// the TF32 value nearest x (ties away from zero), as fp32 bits with the low
// 13 mantissa bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// keep the compiler from moving register work on a wgmma accumulator above
// the wgmma wait: the tensor cores write these registers asynchronously
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128 fp32 fragment, 64 registers a thread) += A (registers, TF32) *
// B (smem, TF32, K-major); scale-d 0 overwrites d.  TF32 has no transpose
// mode: both operands are K-major
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// one slab's products into d.  B_hi and B_lo: K-major, 8-row groups 1024
// bytes apart; a k8 step is 32 bytes along the swizzled row.  The small
// terms go first, while the sum is small; `keep` is the scale-d of the
// first product (0 starts d anew)
__device__ __forceinline__ void slab_mma(float (&d)[kSplitBN / 2], const uint32_t (&hi)[kSplitBK / 8][4],
                                         const uint32_t (&lo)[kSplitBK / 8][4], uint32_t bhi,
                                         uint32_t blo, int keep) {
  if constexpr (kPasses == 3) {
#pragma unroll
    for (int kk = 0; kk < kSplitBK / 8; ++kk)
      wgmma_tf32_n128(d, lo[kk], smem_desc(bhi + kk * 32, 16, 1024), kk > 0 ? 1 : keep);
#pragma unroll
    for (int kk = 0; kk < kSplitBK / 8; ++kk)
      wgmma_tf32_n128(d, hi[kk], smem_desc(blo + kk * 32, 16, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kSplitBK / 8; ++kk)
    wgmma_tf32_n128(d, hi[kk], smem_desc(bhi + kk * 32, 16, 1024),
                   (kPasses == 3 || kk > 0) ? 1 : keep);
}

struct SplitTile {
  static constexpr int kABytes = kBM * kSplitBK * 4;        // a (BM x 32) slab of A
  static constexpr int kBBytes = kSplitBN * kSplitBK * 4;   // a (BN x 32) slab of B_hi or of B_lo
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kEpiBytes = 2 * 2 * kSplitCBytes;  // two chunk buffers per consumer
  static constexpr int kFitStages = (kSmemLimit - 2048 - kEpiBytes) / kStageBytes;
  static constexpr int kStages = kFitStages;
  static constexpr int kSmem = kStages * kStageBytes + kEpiBytes + 1024 + 2 * kStages * 8;
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "shared memory");
};

// B (K, N) row-major -> B^T as two (N, K) K-major arrays, hi = tf32(b) and
// lo = tf32(b - hi), through a (32 x 33) shared tile so that the reads run
// along N and the writes along K; one CTA of 32 x 8 threads per 32 x 32
// tile, the tiles on a 1D grid (N tiles fastest)
__global__ void __launch_bounds__(256)
matmul_split_b_kernel(const float* __restrict__ B, float* __restrict__ hi, float* __restrict__ lo,
                      int K, int N) {
  __shared__ float tile[kSplitT][kSplitT + 1];
  const int n_blocks = (N + kSplitT - 1) / kSplitT;
  const int n0 = (blockIdx.x % n_blocks) * kSplitT;
  const int k0 = (blockIdx.x / n_blocks) * kSplitT;
  const int tx = threadIdx.x % kSplitT, ty = threadIdx.x / kSplitT;
#pragma unroll
  for (int i = ty; i < kSplitT; i += 256 / kSplitT) {
    const int k = k0 + i, n = n0 + tx;
    if (k < K && n < N) tile[i][tx] = B[(int64_t)k * N + n];
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kSplitT; i += 256 / kSplitT) {
    const int n = n0 + i, k = k0 + tx;
    if (n < N && k < K) {
      const float x = tile[tx][i];
      const float h = __uint_as_float(tf32_rna(x));
      hi[(int64_t)n * K + k] = h;
      lo[(int64_t)n * K + k] = __uint_as_float(tf32_rna(x - h));
    }
  }
}

__global__ void __launch_bounds__(kWgmmaThreads, 1)
matmul_split_tf32_kernel(const __grid_constant__ CUtensorMap tma_a,
                         const __grid_constant__ CUtensorMap tma_bhi,
                         const __grid_constant__ CUtensorMap tma_blo,
                         const __grid_constant__ CUtensorMap tma_c, int M, int N, int K) {
  using T = SplitTile;
  constexpr int BN = kSplitBN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sa = base;                                // [stages][BM][32], swizzled
  const uint32_t sb = base + T::kStages * T::kABytes;      // [stages][hi, lo][BN][32], swizzled
  const uint32_t sc = sb + T::kStages * 2 * T::kBBytes;    // [2 consumers][2][64][32], swizzled
  const uint32_t bars = sc + T::kEpiBytes;                 // full[stages], empty[stages]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (T::kStages + s); };

  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int ktiles = (K + kSplitBK - 1) / kSplitBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full(s), 1);   // the producer's arrive.expect_tx
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        tile_coords(t, m_tiles, n_tiles, mt, nt);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % T::kStages;
          const uint32_t b = sb + s * 2 * T::kBBytes;
          mbar_wait(empty(s), ((it / T::kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), T::kStageBytes);
          tma_load_2d(sa + s * T::kABytes, &tma_a, kt * kSplitBK, mt * kBM, full(s));
          tma_load_2d(b, &tma_bhi, kt * kSplitBK, nt * BN, full(s));
          tma_load_2d(b + T::kBBytes, &tma_blo, kt * kSplitBK, nt * BN, full(s));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1;  // rows 64*half .. 64*half+63 of the tile
    const int warp = tid / 32, lane = tid % 32;
    // ldmatrix.x4 of k8 step kk: lane l gives the address of row l % 8
    // (+8 for l % 16 >= 8) of its warp's 16 rows, 16-byte chunk 2 kk + l / 16
    // (4 fp32 of k), which the 128-byte swizzle puts at chunk ^ (row % 8).
    // Matrix i lands in register i: thread (g = lane / 4, q = lane % 4) gets
    // A(g, q), A(g+8, q), A(g, q+4), A(g+8, q+4) of the 16 x 8 step, the
    // m64nNk8 TF32 A fragment
    const int lrow = half * 64 + warp * 16 + (lane & 15);
    const int lchunk = lane >> 4;
    float acc[BN / 2];
    float part[BN / 2];  // the slab sum (unused without kPromote)
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, nt;
      tile_coords(t, m_tiles, n_tiles, mt, nt);
      if constexpr (kPromote) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      }
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % T::kStages;
        mbar_wait(full(s), (it / T::kStages) & 1);
        const uint32_t a0 = sa + s * T::kABytes + lrow * 128;
        const uint32_t bhi = sb + s * 2 * T::kBBytes;
        const uint32_t blo = bhi + T::kBBytes;
        // A split once a slab, in registers: hi = tf32(a), lo = tf32(a - hi)
        uint32_t hi[kSplitBK / 8][4], lo[kSplitBK / 8][4];
#pragma unroll
        for (int kk = 0; kk < kSplitBK / 8; ++kk) {
          uint32_t x[4];
          ldmatrix_x4(x, a0 + (((2 * kk + lchunk) ^ (lrow & 7)) << 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[kk][e] = tf32_rna(__uint_as_float(x[e]));
            lo[kk][e] = tf32_rna(__uint_as_float(x[e]) - __uint_as_float(hi[kk][e]));
          }
        }
        wgmma_fence();
        if constexpr (kPromote)
          slab_mma(part, hi, lo, bhi, blo, 0);
        else
          slab_mma(acc, hi, lo, bhi, blo, kt > 0 ? 1 : 0);
        wgmma_commit();
        wgmma_wait<0>();  // the A fragments are reused next slab, and the slab sum is read now
        if (tid == 0) mbar_arrive(empty(s));
        if constexpr (kPromote) {
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
        }
      }
      fence_regs(acc);

      // the epilogue, in 32-column chunks through two swizzled buffers, one
      // TMA store per chunk, which clips what lies outside C and runs on
      // while the next tile is multiplied.  Register 4j+e of the m64nBN
      // fragment holds row 16*warp + lane/4 (+8 for e >= 2), column
      // 8j + 2*(lane%4) + (e & 1): bytes 32 jj + 8 (lane%4) + 4 (e & 1) of
      // the chunk's row, 16-byte unit 2 jj + (lane%4) / 2
      const int r = warp * 16 + lane / 4;
#pragma unroll
      for (int c = 0; c < BN / kSplitBox; ++c) {
        const uint32_t buf = sc + (half * 2 + (c & 1)) * kSplitCBytes;
        if (tid == 0) tma_store_wait_read<1>();  // the store that last read buf is done
        warpgroup_sync(1 + half);
#pragma unroll
        for (int jj = 0; jj < kSplitBox / 8; ++jj) {
          const int j = c * (kSplitBox / 8) + jj;
          const uint32_t off = r * 128 + (((2 * jj + (lane % 4) / 2) ^ (r & 7)) << 4) + (lane % 2) * 8;
          *reinterpret_cast<float2*>(smem_raw + (buf - raw) + off) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(smem_raw + (buf - raw) + off + 8 * 128) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        fence_async_shared();
        warpgroup_sync(1 + half);
        if (tid == 0) tma_store_2d(&tma_c, buf, nt * BN + c * kSplitBox, mt * kBM + half * 64);
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores: the split route's "before", kept for the ablation
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;

template <int BM, int BN, int BK>
constexpr int f32_smem_bytes() {
  return 2 * (BK * (BM + 4) + BK * BN) * 4;
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kF32Threads)
matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K) {
  constexpr int TM = BM / 16;  // rows of a thread, in groups of 4 at stride 64
  constexpr int TN = BN / 16;
  constexpr int AS = BM + 4;   // A^T row stride (floats)
  constexpr int A_LOADS = BM * BK / 4 / kF32Threads;
  constexpr int B_LOADS = BK * BN / 4 / kF32Threads;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && A_LOADS >= 1 && B_LOADS >= 1, "bad tile");

  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [2][BK][AS], A transposed
  float* Bs = As + 2 * BK * AS;                // [2][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  float4 ra[A_LOADS], rb[B_LOADS];
  auto gload = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int c = tid + i * kF32Threads;
      const int r = c / (BK / 4), gk = k0 + (c % (BK / 4)) * 4, gm = m0 + r;
      ra[i] = (gm < M && gk < K) ? *reinterpret_cast<const float4*>(A + (int64_t)gm * K + gk)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * kF32Threads;
      const int gk = k0 + c / (BN / 4), gn = n0 + (c % (BN / 4)) * 4;
      rb[i] = (gk < K && gn < N) ? *reinterpret_cast<const float4*>(B + (int64_t)gk * N + gn)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto sstore = [&](int buf) {
    float* as = As + buf * BK * AS;
    float* bs = Bs + buf * BK * BN;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int c = tid + i * kF32Threads;
      const int r = c / (BK / 4), k = (c % (BK / 4)) * 4;
      as[(k + 0) * AS + r] = ra[i].x;
      as[(k + 1) * AS + r] = ra[i].y;
      as[(k + 2) * AS + r] = ra[i].z;
      as[(k + 3) * AS + r] = ra[i].w;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * kF32Threads;
      *reinterpret_cast<float4*>(bs + (c / (BN / 4)) * BN + (c % (BN / 4)) * 4) = rb[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) gload(kt + 1);
    const float* as = As + cur * BK * AS;
    const float* bs = Bs + cur * BK * BN;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(as + k * AS + g * 64 + ty * 4);
        a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * BN + g * 64 + tx * 4);
        b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) sstore(cur ^ 1);  // the buffer read in iteration kt-1
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int col = n0 + g * 64 + tx * 4;  // N % 4 == 0: all four or none
      if (col < N)
        *reinterpret_cast<float4*>(C + (int64_t)row * N + col) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
  }
}

// one CTA per SM at most (persistent), fewer when there are fewer tiles
cudaError_t persistent_grid(int tiles, int& grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  grid = tiles < sms ? tiles : sms;
  return err;
}

template <int BN>
int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
  using T = WgmmaTile<BN>;
  CUtensorMap ma, mb, mc;
  int rc = encode_bf16(&ma, a, M, K, kBM);           // A (M, K): boxes of 128 rows x 64 k
  if (rc == 0) rc = encode_bf16(&mb, b, K, N, kBK);  // B (K, N): boxes of 64 k x 64 n
  if (rc == 0) rc = encode_bf16(&mc, c, M, N, 64);   // C (M, N): chunks of 64 rows x 64 n
  if (rc != 0) return rc;
  int grid = 0;
  cudaError_t err = persistent_grid(((M + kBM - 1) / kBM) * ((N + BN - 1) / BN), grid);
  auto kern = matmul_wgmma_kernel<BN>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kWgmmaThreads, T::kSmem, s>>>(ma, mb, mc, M, N, K);
  return (int)cudaGetLastError();
}

int launch_split_b(const void* b, void* hi, void* lo, int K, int N, cudaStream_t s) {
  const int blocks = ((N + kSplitT - 1) / kSplitT) * ((K + kSplitT - 1) / kSplitT);
  matmul_split_b_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(b),
                                               static_cast<float*>(hi), static_cast<float*>(lo),
                                               K, N);
  return (int)cudaGetLastError();
}

int launch_split_tf32(const void* a, const void* bhi, const void* blo, void* c, int M, int N, int K,
                      cudaStream_t s) {
  using T = SplitTile;
  constexpr int BN = kSplitBN;
  CUtensorMap ma, mh, ml, mc;
  int rc = encode_f32(&ma, a, M, K, kBM);            // A (M, K): boxes of 128 rows x 32 k
  if (rc == 0) rc = encode_f32(&mh, bhi, N, K, BN);  // B_hi (N, K): boxes of BN n x 32 k
  if (rc == 0) rc = encode_f32(&ml, blo, N, K, BN);  // B_lo likewise
  if (rc == 0) rc = encode_f32(&mc, c, M, N, 64);    // C (M, N): chunks of 64 rows x 32 n
  if (rc != 0) return rc;
  int grid = 0;
  cudaError_t err = persistent_grid(((M + kBM - 1) / kBM) * ((N + BN - 1) / BN), grid);
  auto kern = matmul_split_tf32_kernel;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kWgmmaThreads, T::kSmem, s>>>(ma, mh, ml, mc, M, N, K);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int BK>
int launch_f32(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
  constexpr int smem = f32_smem_bytes<BM, BN, BK>();
  auto kern = matmul_f32_kernel<BM, BN, BK>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, 1);
  kern<<<grid, kF32Threads, smem, s>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                       static_cast<float*>(c), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// elem_bytes 2 (bf16, wgmma) or 4 (fp32, the CUDA-core kernel) and a
// (bm, bn, bk) of the instantiated tiles; anything else returns
// cudaErrorInvalidValue without launching.
int matmul_tiled_launch(int elem_bytes, const void* a, const void* b, void* c, int M, int N,
                        int K, int bm, int bn, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2 && bm == kBM && bk == kBK) {
    if (bn == 256) return launch_wgmma<256>(a, b, c, M, N, K, s);
    if (bn == 128) return launch_wgmma<128>(a, b, c, M, N, K, s);
  } else if (elem_bytes == 4) {
    if (bm == 128 && bn == 128 && bk == 16) return launch_f32<128, 128, 16>(a, b, c, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

// B (K, N) fp32 -> hi, lo (N, K): B^T split into its TF32 parts
int matmul_split_b_launch(const void* b, void* hi, void* lo, int K, int N, void* stream) {
  return launch_split_b(b, hi, lo, K, N, static_cast<cudaStream_t>(stream));
}

// C (M, N) = A (M, K) B in fp32 from B's split parts b_hi, b_lo (N, K), in
// three TF32 passes; (bm, bn, bk) must be the instantiated 128 x 128 x 32,
// anything else returns cudaErrorInvalidValue without launching.
int matmul_split_tf32_launch(const void* a, const void* b_hi, const void* b_lo, void* c, int M,
                             int N, int K, int bm, int bn, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == kBM && bn == kSplitBN && bk == kSplitBK)
    return launch_split_tf32(a, b_hi, b_lo, c, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

const char* matmul_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused the operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
