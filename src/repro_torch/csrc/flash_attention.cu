// Hand-written Hopper (sm_90a) attention kernels: causal GQA flash attention
// (prefill) and single-token decode against a KV cache
//
//   q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D), o (B, Hq, Sq, D), contiguous;
//   query head h reads KV head h / (Hq / Hkv); scale = D^-1/2.
//
// Both keep the reference's online softmax as the TPU kernels write it:
// f32 running max m and sum l, masked scores set to the finite
// NEG_INF = -1e30 (not -inf), per KV block m' = max(m, rowmax s),
// p = exp(s - m'), l = l e^(m - m') + sum p, acc = acc e^(m - m') + p v,
// and o = acc / max(l, 1e-30).  Two departures from the reference's f32
// arithmetic: exp is __expf (the hardware ex2.approx path, a few ulp), and
// the bf16 forward rounds p to bf16 for the tensor-core P V product while l
// sums the unrounded p.  The fp32 kernels and the decode kernel keep p in
// f32.
//
// flash_attention_fwd
//   Replaces repro/kernels/flash_attention/kernel.py:
//   make_flash_attention(B, Hq, Hkv, Sq, Skv, D, bq, bk, causal) (grid
//   (B*Hq, Sq/bq, Skv/bk), KV blocks innermost, f32 scratch).  One CTA per
//   (b*Hq + h, q block of BQ rows); the TPU's sequential KV axis becomes a
//   loop inside the CTA over KV blocks of BK rows.  Causal: the mask keeps
//   key j for query i when j <= i + (Skv - Sq), and KV block kb is skipped
//   when kb*BK > qb*BQ + BQ - 1 + (Skv - Sq), as the reference's pl.when does.
//   Heavy (late) query blocks are scheduled first.
//
//   bf16: tensor cores through mma.sync.m16n8k16 (FA2 form).  BQ/16 warps,
//   each owning 16 query rows: S = Q K^T and O += P V as m16n8k16 tiles, Q
//   fragments in registers, K and V blocks double-buffered in shared memory
//   by cp.async (rows padded by 8 elements against bank conflicts), P reused
//   from the S accumulators as the A operand, rounded to bf16 (a relative
//   error of at most 2^-9 on each p).  Bound at the model's
//   prefill: tensor-core operations.
//
//   fp32: CUDA-core FMAs (no TF32).  256 threads as 16 x 16; S and O in
//   registers, Q^T, K^T, V and P^T in shared memory.
//
// flash_decode
//   Replaces repro/kernels/flash_attention/kernel.py:
//   make_flash_decode(B, Hq, Hkv, Skv, D, bk) (grid (B*Hq, Skv/bk)).  One CTA
//   per (b, KV head) serves up to 8 query heads of that KV head's group, so
//   K and V are read once; it walks the cache in blocks of bk keys: the
//   block's scores go to shared memory, the block max and sum are reduced
//   over the CTA, and every thread accumulates p v for its keys.  Lanes read
//   16 B each, D/8 (bf16) or D/4 (fp32) lanes to a key row.  Bound: DRAM
//   bytes (K and V once).  Every element offset is 64-bit: at B = 128,
//   Skv = 32768, Hkv = 8, D = 64 K alone has 2^31 elements.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr float kMinDenom = 1e-30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The last KV block a q block processes: every block for a non-causal
// call, else the blocks kb with kb*BK <= qb*BQ + BQ - 1 + off (-1: none).
__device__ __forceinline__ int last_kv_block(int causal, int qb, int bq, int bk, int nk,
                                             int off) {
  if (!causal) return nk - 1;
  const int lim = qb * bq + bq - 1 + off;
  return lim < 0 ? -1 : min(nk - 1, lim / bk);
}

template <int BQ, int BK, int D>
constexpr int fwd_bf16_smem_bytes() {
  return (BQ + 4 * BK) * (D + 8) * 2;
}

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(BQ * 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                      const bf16* __restrict__ V, bf16* __restrict__ O, int Hq, int Hkv,
                      int Sq, int Skv, float scale, int causal) {
  constexpr int THREADS = BQ * 2;  // BQ / 16 warps
  constexpr int DS = D + 8;        // shared row stride (elements), padded
  constexpr int NS = BK / 8;       // n8 tiles of a warp's S
  constexpr int NO = D / 8;        // n8 tiles of a warp's O
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && D % 16 == 0, "bad tile");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][DS]
  bf16* Ks = Qs + BQ * DS;                   // [2][BK][DS]
  bf16* Vs = Ks + 2 * BK * DS;               // [2][BK][DS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;                      // b*Hq + h
  const int qb = gridDim.y - 1 - blockIdx.y;      // heavy causal blocks first
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int off = Skv - Sq;
  const int last = last_kv_block(causal, qb, BQ, BK, Skv / BK, off);
  const bf16* qg = Q + ((int64_t)bh * Sq + (int64_t)qb * BQ) * D;
  const bf16* kg = K + ((int64_t)b * Hkv + kvh) * Skv * D;
  const bf16* vg = V + ((int64_t)b * Hkv + kvh) * Skv * D;

  for (int c = tid; c < BQ * D / 8; c += THREADS) {
    const int r = c / (D / 8), ch = c % (D / 8);
    cp_async_16(smem_u32(Qs + r * DS + ch * 8), qg + (int64_t)r * D + ch * 8);
  }
  auto load_kv = [&](int buf, int kb) {
    const int64_t base = (int64_t)kb * BK * D;
    for (int c = tid; c < BK * D / 8; c += THREADS) {
      const int r = c / (D / 8), ch = c % (D / 8);
      const int64_t g = base + (int64_t)r * D + ch * 8;
      cp_async_16(smem_u32(Ks + (buf * BK + r) * DS + ch * 8), kg + g);
      cp_async_16(smem_u32(Vs + (buf * BK + r) * DS + ch * 8), vg + g);
    }
  };
  if (last >= 0) load_kv(0, 0);
  cp_async_commit();

  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix.x4 lane -> row
  const int lcol = (lane >> 4) * 8;                      //                 -> column
  // the two query rows of this thread: row0 and row0 + 8 of the q block
  const int row0 = warp * 16 + (lane >> 2);

  uint32_t qf[D / 16][4];
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  for (int kb = 0; kb <= last; ++kb) {
    if (kb + 1 <= last) load_kv((kb + 1) & 1, kb + 1);
    cp_async_commit();
    cp_async_wait<1>();  // block kb (and Q) have landed
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int t = 0; t < D / 16; ++t)
        ldmatrix_x4(qf[t], smem_u32(Qs + (warp * 16 + lrow) * DS + t * 16 + lcol));
    }
    const bf16* ks = Ks + (kb & 1) * BK * DS;
    const bf16* vs = Vs + (kb & 1) * BK * DS;

    // S = Q K^T: K rows (keys) are the B operand's columns, so ldmatrix
    // without .trans; the x4 matrices are (keys 0-7, d 0-7), (keys 0-7,
    // d 8-15), (keys 8-15, d 0-7), (keys 8-15, d 8-15)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t kf[4];
        const int key = j * 16 + (lane & 7) + (lane >> 4) * 8;
        const int d = t * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kf, smem_u32(ks + key * DS + d));
        mma_bf16(s[2 * j], qf[t], kf[0], kf[1]);
        mma_bf16(s[2 * j + 1], qf[t], kf[2], kf[3]);
      }
    }

    // scale, mask, online softmax; s[j][0..1] belong to row0, s[j][2..3] to row0 + 8
    const bool mask = causal && (kb * BK + BK - 1 > qb * BQ + off);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e] * scale;
        if (mask) {
          const int col = kb * BK + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = qb * BQ + row0 + (e >> 1) * 8 + off;
          if (col > row) v = kNegInf;
        }
        s[j][e] = v;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float corr = __expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * r] = __expf(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = __expf(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * corr + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }

    // O += P V: the S accumulators of n8 tiles 2t and 2t+1 are the A
    // fragment of k step t; V rows (keys) are the B operand's k, so .trans
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int j = 0; j < NO / 2; ++j) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(vs + (t * 16 + lrow) * DS + j * 16 + lcol));
        mma_bf16(o[2 * j], pa, vf[0], vf[1]);
        mma_bf16(o[2 * j + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // buffer kb & 1 is free for block kb + 2
  }
  cp_async_wait<0>();

  bf16* og = O + ((int64_t)bh * Sq + (int64_t)qb * BQ) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l_run[r], kMinDenom);
    bf16* orow = og + (int64_t)(row0 + r * 8) * D + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
}

template <int BQ, int BK, int D>
constexpr int fwd_f32_smem_bytes() {
  return (D * (BQ + 1) + D * (BK + 1) + BK * D + BK * (BQ + 1)) * 4;
}

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(256)
flash_fwd_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                     const float* __restrict__ V, float* __restrict__ O, int Hq, int Hkv,
                     int Sq, int Skv, float scale, int causal) {
  constexpr int TM = BQ / 16;  // rows of a thread: ty + 16 r
  constexpr int TN = BK / 16;  // S columns of a thread: tx + 16 c
  constexpr int TD = D / 16;   // O columns of a thread: tx + 16 e
  constexpr int QS = BQ + 1, KS = BK + 1;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qt = reinterpret_cast<float*>(smem);  // [D][QS]  Q transposed
  float* Kt = Qt + D * QS;                     // [D][KS]  K transposed
  float* Vs = Kt + D * KS;                     // [BK][D]
  float* Pt = Vs + BK * D;                     // [BK][QS] P transposed

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int off = Skv - Sq;
  const int last = last_kv_block(causal, qb, BQ, BK, Skv / BK, off);
  const float* qg = Q + ((int64_t)bh * Sq + (int64_t)qb * BQ) * D;
  const float* kg = K + ((int64_t)b * Hkv + kvh) * Skv * D;
  const float* vg = V + ((int64_t)b * Hkv + kvh) * Skv * D;

  for (int i = tid; i < BQ * D; i += 256) Qt[(i % D) * QS + i / D] = qg[i];

  float o[TM][TD], m_run[TM], l_run[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < TD; ++e) o[r][e] = 0.f;
  }

  for (int kb = 0; kb <= last; ++kb) {
    __syncthreads();  // the previous block's K, V and P are consumed
    const int64_t base = (int64_t)kb * BK * D;
    for (int i = tid; i < BK * D; i += 256) {
      Kt[(i % D) * KS + i / D] = kg[base + i];
      Vs[i] = vg[base + i];
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TM], k[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = Qt[d * QS + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < TN; ++c) k[c] = Kt[d * KS + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) s[r][c] = fmaf(a[r], k[c], s[r][c]);
    }

    const bool mask = causal && (kb * BK + BK - 1 > qb * BQ + off);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = qb * BQ + ty + 16 * r + off;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        float v = s[r][c] * scale;
        if (mask && kb * BK + tx + 16 * c > row) v = kNegInf;
        s[r][c] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_run[r], mx);
      const float corr = __expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const float p = __expf(s[r][c] - m_new);
        Pt[(tx + 16 * c) * QS + ty + 16 * r] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l_run[r] = l_run[r] * corr + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int e = 0; e < TD; ++e) o[r][e] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[TM], v[TD];
#pragma unroll
      for (int r = 0; r < TM; ++r) p[r] = Pt[j * QS + ty + 16 * r];
#pragma unroll
      for (int e = 0; e < TD; ++e) v[e] = Vs[j * D + tx + 16 * e];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int e = 0; e < TD; ++e) o[r][e] = fmaf(p[r], v[e], o[r][e]);
    }
  }

  float* og = O + ((int64_t)bh * Sq + (int64_t)qb * BQ) * D;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const float denom = fmaxf(l_run[r], kMinDenom);
#pragma unroll
    for (int e = 0; e < TD; ++e) og[(int64_t)(ty + 16 * r) * D + tx + 16 * e] = o[r][e] / denom;
  }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;

__device__ __forceinline__ void load_vec(const bf16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void from_float(float x, bf16* p) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void from_float(float x, float* p) { *p = x; }

// the CTA-wide max (or sum) of one value per thread for each of G heads;
// every thread gets the results
template <int G, bool kMax>
__device__ __forceinline__ void block_reduce(float (&x)[G], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[g], w);
      x[g] = kMax ? fmaxf(x[g], y) : x[g] + y;
    }
    if (lane == 0) red[warp * G + g] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float acc = red[g];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) acc = kMax ? fmaxf(acc, red[w * G + g]) : acc + red[w * G + g];
    x[g] = acc;
  }
  __syncthreads();  // red is reused by the next reduction
}

template <typename T, int D, int G>
constexpr int decode_smem_bytes(int bk) {
  return (G * bk + kDecWarps * G + kDecWarps * G * D) * 4;
}

// grid (B*Hkv, ceil(group / G)); CTA (b, kvh, chunk) serves query heads
// kvh*group + chunk*G + g for g < min(G, group - chunk*G)
template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                    T* __restrict__ O, int Hq, int Hkv, int Skv, int bk, float scale) {
  constexpr int VEC = 16 / sizeof(T);      // elements of one 16-byte load
  constexpr int LANES = D / VEC;           // lanes to a key row
  constexpr int WORKERS = kDecThreads / LANES;
  static_assert(32 % LANES == 0, "a key row must fit a warp");

  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);  // [G][bk] scores, then p
  float* red = sc + G * bk;                    // [warps][G]
  float* part = red + kDecWarps * G;           // [warps][G][D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int worker = tid / LANES, sub = tid % LANES;
  const int bkv = blockIdx.x;  // b*Hkv + kvh
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int group = Hq / Hkv;
  const int g0 = blockIdx.y * G;
  const int ng = min(G, group - g0);
  const int h0 = kvh * group + g0;

  float q[G][VEC], acc[G][VEC], m_run[G], l_run[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[g][e] = 0.f;
      q[g][e] = g < ng ? to_float(Q[((int64_t)b * Hq + h0 + g) * D + sub * VEC + e]) : 0.f;
    }
  }
  const T* kg = K + (int64_t)bkv * Skv * D + sub * VEC;
  const T* vg = V + (int64_t)bkv * Skv * D + sub * VEC;

  for (int k0 = 0; k0 < Skv; k0 += bk) {
    // scores of the block's keys k0 + worker + WORKERS*i
#pragma unroll 4
    for (int j = worker; j < bk; j += WORKERS) {
      float kv[VEC];
      load_vec(kg + (int64_t)(k0 + j) * D, kv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(q[g][e], kv[e], dot);
#pragma unroll
        for (int w = LANES / 2; w >= 1; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
        if (sub == 0) sc[g * bk + j] = dot * scale;
      }
    }
    __syncthreads();

    float mx[G], sum[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mx[g] = kNegInf;
      for (int j = tid; j < bk; j += kDecThreads) mx[g] = fmaxf(mx[g], sc[g * bk + j]);
    }
    block_reduce<G, true>(mx, red);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_new = fmaxf(m_run[g], mx[g]);
      const float corr = __expf(m_run[g] - m_new);
      sum[g] = 0.f;
      for (int j = tid; j < bk; j += kDecThreads) {
        const float p = __expf(sc[g * bk + j] - m_new);
        sc[g * bk + j] = p;
        sum[g] += p;
      }
      m_run[g] = m_new;
      l_run[g] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
    }
    block_reduce<G, false>(sum, red);  // its barriers also publish p
#pragma unroll
    for (int g = 0; g < G; ++g) l_run[g] += sum[g];

#pragma unroll 4
    for (int j = worker; j < bk; j += WORKERS) {
      float vv[VEC];
      load_vec(vg + (int64_t)(k0 + j) * D, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sc[g * bk + j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
    __syncthreads();  // sc is rewritten by the next block
  }

  // sum acc over the workers: first the workers of a warp (lanes that share
  // ``sub``), then the warps through shared memory
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float x = acc[g][e];
#pragma unroll
      for (int w = LANES; w < 32; w <<= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
      if (lane < LANES) part[(warp * G + g) * D + sub * VEC + e] = x;
    }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[g] = fmaxf(l_run[g], kMinDenom);  // every thread holds l
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += kDecThreads) {
    const int g = i / D, d = i % D;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) x += part[(w * G + g) * D + d];
    from_float(x / red[g], O + ((int64_t)b * Hq + h0 + g) * D + d);
  }
}

template <typename Kern>
int set_smem(Kern kern, int bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BQ, int BK, int D>
int launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                    int Hkv, int Sq, int Skv, float scale, int causal, cudaStream_t s) {
  constexpr int smem = fwd_bf16_smem_bytes<BQ, BK, D>();
  auto kern = flash_fwd_bf16_kernel<BQ, BK, D>;
  if (int err = set_smem(kern, smem)) return err;
  kern<<<dim3(B * Hq, Sq / BQ), BQ * 2, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Hq, Hkv, Sq, Skv, scale, causal);
  return (int)cudaGetLastError();
}

template <int BQ, int BK, int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                   int Sq, int Skv, float scale, int causal, cudaStream_t s) {
  constexpr int smem = fwd_f32_smem_bytes<BQ, BK, D>();
  auto kern = flash_fwd_f32_kernel<BQ, BK, D>;
  if (int err = set_smem(kern, smem)) return err;
  kern<<<dim3(B * Hq, Sq / BQ), 256, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Hq, Hkv, Sq, Skv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D, int G>
int launch_decode(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                  int Skv, int bk, float scale, cudaStream_t s) {
  const int smem = decode_smem_bytes<T, D, G>(bk);
  auto kern = flash_decode_kernel<T, D, G>;
  if (int err = set_smem(kern, smem)) return err;
  const int chunks = (Hq / Hkv + G - 1) / G;
  kern<<<dim3(B * Hkv, chunks), kDecThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Skv, bk, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_decode(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                    int Skv, int bk, float scale, cudaStream_t s) {
  const int group = Hq / Hkv;
  if (group <= 1) return launch_decode<T, D, 1>(q, k, v, o, B, Hq, Hkv, Skv, bk, scale, s);
  if (group <= 2) return launch_decode<T, D, 2>(q, k, v, o, B, Hq, Hkv, Skv, bk, scale, s);
  if (group <= 4) return launch_decode<T, D, 4>(q, k, v, o, B, Hq, Hkv, Skv, bk, scale, s);
  return launch_decode<T, D, 8>(q, k, v, o, B, Hq, Hkv, Skv, bk, scale, s);
}

}  // namespace

extern "C" {

// elem_bytes 2 (bf16) or 4 (fp32), D and (bq, bk) of the instantiated
// kernels (bf16: D 32, 64 or 128; fp32: D 32 or 64; both (128, 128) and
// (64, 64)); anything else returns cudaErrorInvalidValue without launching.
int flash_fwd_launch(int elem_bytes, const void* q, const void* k, const void* v, void* o, int B,
                     int Hq, int Hkv, int Sq, int Skv, int D, int bq, int bk, float scale,
                     int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool big = bq == 128 && bk == 128, small = bq == 64 && bk == 64;
  if (!big && !small) return (int)cudaErrorInvalidValue;
#define FWD(KERN, BQ, BK, HD) KERN<BQ, BK, HD>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, s)
#define FWD_TILES(KERN, HD) return big ? FWD(KERN, 128, 128, HD) : FWD(KERN, 64, 64, HD)
  if (elem_bytes == 2) {
    if (D == 32) FWD_TILES(launch_fwd_bf16, 32);
    if (D == 64) FWD_TILES(launch_fwd_bf16, 64);
    if (D == 128) FWD_TILES(launch_fwd_bf16, 128);
  } else if (elem_bytes == 4) {
    if (D == 32) FWD_TILES(launch_fwd_f32, 32);
    if (D == 64) FWD_TILES(launch_fwd_f32, 64);
  }
#undef FWD_TILES
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// elem_bytes 2 or 4, D 32, 64 or 128, bk a multiple of 64 that divides Skv
int flash_decode_launch(int elem_bytes, const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Skv, int D, int bk, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEC(T, HD) return dispatch_decode<T, HD>(q, k, v, o, B, Hq, Hkv, Skv, bk, scale, s)
  if (elem_bytes == 2) {
    if (D == 32) DEC(bf16, 32);
    if (D == 64) DEC(bf16, 64);
    if (D == 128) DEC(bf16, 128);
  } else if (elem_bytes == 4) {
    if (D == 32) DEC(float, 32);
    if (D == 64) DEC(float, 64);
    if (D == 128) DEC(float, 128);
  }
#undef DEC
  return (int)cudaErrorInvalidValue;
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
