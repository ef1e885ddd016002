// Hand-written Hopper (sm_90a) GEMM kernels
//
//   C = A · B,   A (M, K), B (K, N), C (M, N), all row-major and contiguous,
//   accumulated in fp32 and cast to the output dtype (the inputs' dtype).
//
// matmul_tiled
//   Replaces the TPU kernel repro/kernels/matmul/kernel.py:
//   make_matmul(M, K, N, bm, bk, bn) (grid (M/bm, N/bn, K/bk), k innermost,
//   an f32 VMEM accumulator written once at the last k step).  The TPU's
//   sequential k axis becomes a loop inside the CTA: one CTA per (BM, BN)
//   output tile walks K in BK slabs staged through shared memory and keeps
//   the f32 accumulator in registers.  The TPU's 128..1024 VMEM blocks do
//   not fit a CTA; the CTA tiles are this kernel's own (instantiated below).
//
//   bf16: tensor cores through warp-level mma.sync.m16n8k16 (bf16 in, f32
//   accumulate).  8 warps, 2 x 4 over the tile; each warp owns a
//   (BM/2) x (BN/4) sub-tile.  Slabs arrive by cp.async (16 B a thread) in a
//   3-stage ring, so the next two slabs load while one is multiplied;
//   fragments come from shared memory by ldmatrix (B with .trans), the rows
//   padded by 8 elements so that the 8 row addresses of an ldmatrix fall in
//   8 different bank groups.  Bound on the H100 at the model's shapes:
//   tensor-core operations (989 TFLOP/s dense bf16); mma.sync reaches only
//   part of that rate (wgmma and TMA are the later redesign).
//
//   fp32: CUDA-core FMAs (no TF32: the reference's fp32 tolerance would not
//   survive it).  256 threads as 16 x 16; each thread owns TM x TN outputs
//   in groups of 4 rows / 4 columns at a stride of 64, so that its
//   float4 reads from shared memory are conflict-free; A is stored
//   transposed in shared memory; the next slab is loaded into registers
//   while the current one is multiplied (two shared buffers).  Bound:
//   fp32 operations (67 TFLOP/s).
//
//   Edges: rows and columns beyond M, N and the K tail are masked (zero-fill
//   on load, guarded stores), so no dimension needs to be a tile multiple.
//   Loads are 16 B wide: K and N must be multiples of 8 (bf16) or 4 (fp32)
//   and the operands 16-byte aligned; the wrapper checks both.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a · b for one m16n8k16 tile: bf16 inputs, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kBf16Threads = kWarpsM * kWarpsN * 32;
constexpr int kStages = 3;

template <int BM, int BN, int BK>
constexpr int bf16_smem_bytes() {
  return kStages * (BM * (BK + 8) + BK * (BN + 8)) * 2;
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kBf16Threads)
matmul_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                   bf16* __restrict__ C, int M, int N, int K) {
  constexpr int WTM = BM / kWarpsM;  // warp sub-tile rows
  constexpr int WTN = BN / kWarpsN;  // warp sub-tile columns
  constexpr int MT = WTM / 16;       // m16 tiles of a warp
  constexpr int NT = WTN / 8;        // n8 tiles of a warp
  constexpr int AS = BK + 8;         // shared row strides (elements), padded
  constexpr int BS = BN + 8;
  static_assert(MT >= 1 && NT % 2 == 0 && BK % 16 == 0, "bad tile");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [kStages][BM][AS]
  bf16* Bs = As + kStages * BM * AS;         // [kStages][BK][BS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  auto load_slab = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * BM * AS;
    bf16* bs = Bs + stage * BK * BS;
    constexpr int ACH = BM * BK / 8;  // 16-byte chunks of the A slab
    for (int c = tid; c < ACH; c += kBf16Threads) {
      const int r = c / (BK / 8), ch = c % (BK / 8);
      const int gm = m0 + r, gk = k0 + ch * 8;
      const bool ok = gm < M && gk < K;
      cp_async_16(smem_u32(as + r * AS + ch * 8), ok ? A + (int64_t)gm * K + gk : A, ok);
    }
    constexpr int BCH = BK * BN / 8;
    for (int c = tid; c < BCH; c += kBf16Threads) {
      const int r = c / (BN / 8), ch = c % (BN / 8);
      const int gk = k0 + r, gn = n0 + ch * 8;
      const bool ok = gk < K && gn < N;
      cp_async_16(smem_u32(bs + r * BS + ch * 8), ok ? B + (int64_t)gk * N + gn : B, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_slab(s, s);
    cp_async_commit();
  }

  // lane -> the row / column an ldmatrix.x4 lane addresses: matrices
  // (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15),
  // (rows 8-15, cols 8-15)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // slab kt has landed
    __syncthreads();               // ... for every thread; slab kt-1 is consumed
    const int next = kt + kStages - 1;
    if (next < ktiles) load_slab(next % kStages, next);
    cp_async_commit();

    const bf16* as = As + (kt % kStages) * BM * AS;
    const bf16* bs = Bs + (kt % kStages) * BK * BS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
      uint32_t bfr[NT / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], smem_u32(as + (wm * WTM + i * 16 + lrow) * AS + kk + lcol));
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldmatrix_x4_trans(bfr[j], smem_u32(bs + (kk + lrow) * BS + wn * WTN + j * 16 + lcol));
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          mma_bf16(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
  }
  cp_async_wait<0>();

  // accumulator layout of m16n8: c0, c1 at (lane/4, 2*(lane%4) + {0, 1}),
  // c2, c3 eight rows below; N is even, so a column pair never straddles N
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = m0 + wm * WTM + i * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * WTN + j * 8 + (lane & 3) * 2;
      if (col >= N) continue;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (int64_t)row * N + col) =
            __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (int64_t)(row + 8) * N + col) =
            __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  }
}

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

template <int BM, int BN, int BK>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
  constexpr int smem = bf16_smem_bytes<BM, BN, BK>();
  auto kern = matmul_bf16_kernel<BM, BN, BK>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, 1);
  kern<<<grid, kBf16Threads, smem, s>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                        static_cast<bf16*>(c), M, N, K);
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

// elem_bytes 2 (bf16) or 4 (fp32) and a (bm, bn, bk) of the instantiated
// tiles; anything else returns cudaErrorInvalidValue without launching.
int matmul_tiled_launch(int elem_bytes, const void* a, const void* b, void* c, int M, int N,
                        int K, int bm, int bn, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    if (bm == 128 && bn == 128 && bk == 32) return launch_bf16<128, 128, 32>(a, b, c, M, N, K, s);
    if (bm == 128 && bn == 256 && bk == 32) return launch_bf16<128, 256, 32>(a, b, c, M, N, K, s);
  } else if (elem_bytes == 4) {
    if (bm == 128 && bn == 128 && bk == 16) return launch_f32<128, 128, 16>(a, b, c, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
