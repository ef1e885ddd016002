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
// arithmetic: exp is ex2.approx based (__expf, or 2^x of a log2 e-scaled
// argument in the wgmma kernel; a few ulp), and
// the bf16 forward rounds p to bf16 for the tensor-core P V product while l
// sums the unrounded p.  The fp32 kernels and the decode kernels keep p in
// f32 (the tensor-core decode as the sum of two bf16 parts).
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
//   bf16 at (128, 128), D 64 and 128: flash_fwd_wgmma_kernel, Hopper's own
//   form (FA3).  Bound at the model's prefill by the tensor cores (4·D
//   flops a kept (query, key) pair at 989 TFLOP/s) and, at D = 64, as much
//   by the exponentials: the MUFU unit does 16 ex2 a clock per SM, about
//   as long as the tensor-core bound.  So the design keeps both busy at
//   once.  Persistent CTAs (one per SM) of three warpgroups walk the tiles
//   (b*Hq + h, q block of 128 rows), heavy causal q blocks first; the
//   producer loads the next tile's Q and K while the consumers finish the
//   last one.
//   - Warpgroup 0 is the producer: one thread issues TMA loads of the Q
//     block (once a tile) and of K and V blocks of 128 keys into a ring of
//     kFaStages stages, each tensor viewed as a row-major (B*H*S, D) matrix
//     in (128 x 64) boxes, 128-byte swizzled.  K and V have full and empty
//     mbarriers of their own, so Q K^T starts before V lands.  It drops to
//     40 registers (setmaxnreg); the consumers rise to 232.
//   - Warpgroups 1 and 2 are consumers, 64 query rows each.  S = Q K^T is
//     wgmma m64n128k16 with Q from registers (kQInRegs: its A fragments
//     loaded once a tile by ldmatrix, which frees the Q buffer at once and
//     leaves shared memory to K) and K from shared memory (stored key x D,
//     K-major, so nothing is transposed); O += P V is wgmma m64nDk16 with
//     A from registers (P rounded from the S accumulators: their layout is
//     the A fragment's) and V read MN-major through the transpose-B mode.
//   - Ping-pong (kPingPong): named barriers 1 and 2 give the consumers
//     turns on the tensor cores, so one consumer's softmax runs while the
//     other's two GEMMs (S of block j, P V of block j-1) run.
//   - Inside a consumer (kIntraOverlap): the exponentials of block j wait
//     only for S_j, and run while P_{j-1} V_{j-1} is still on the tensor
//     cores; p is packed to bf16 once that product is done, and O takes
//     block j's correction in the next turn, under S_{j+1}
//     (kRescaleInTurn).
//   The ablation (kernels/flash_attention/ablate.py) times each switch
//   off; at the model's prefill ping-pong and the intra-warpgroup overlap
//   gain nothing measurable, the softmax stays on the critical path
//   (PERF.md).
//   - The softmax works in the exp2 domain: one FFMA (s * scale log2 e -
//     m) and one ex2 an element; the causal mask is applied only in the
//     last KV block (with Sq and Skv multiples of 128 no other block is
//     cut), the others run without mask code.  The epilogue divides by
//     max(l, 1e-30) and stores bf16 pairs from registers.
//
//   bf16 at D 32, and at (64, 64): tensor cores through mma.sync.m16n8k16
//   (FA2 form).  BQ/16 warps,
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
//   make_flash_decode(B, Hq, Hkv, Skv, D, bk) (grid (B*Hq, Skv/bk), one
//   query head a program, KV blocks innermost).  Bound: DRAM bytes, K and V
//   read once (8.59 GB at the model's decode_32k, 2.56 ms at 3.35 TB/s); a
//   KV head's query heads share its K and V, so each key row is read once
//   for all of them.  flash_decode_route picks the kernel:
//
//   bf16 at D 64 and 128 ("tma_mma"): flash_decode_tma_kernel, Hopper's own
//   form.  A work unit is (b, KV head, chunk of up to 16 of its query heads,
//   split of the cache); persistent CTAs (one per SM) walk the units.
//   - One producer thread keeps TMA loads of 128-key K and V blocks in
//     flight: a K ring and a V ring of 6 blocks each at D 64, 3 at D 128
//     (192 KB together either way), each block one or two (128 x 64) boxes,
//     128-byte swizzled, of the (B*Hkv*Skv, D) views, with full and empty
//     mbarriers for K and V apart.  A box may run past the unit's last key
//     (into the next KV head's rows, or zero-filled past the tensor): those
//     keys' scores are set to the finite NEG_INF and add nothing.  Loads
//     never wait for the softmax: the ring is refilled as soon as a
//     consumer releases a stage.
//   - kDecConsumers consumer warps take the blocks in turn (warp w the
//     blocks w, w + n, ...; n divides the stages, so each stage serves one
//     warp and its mbarrier phases are waited on in order), each with its
//     own running max, sum and O for
//     a 16-row tile, with no CTA barrier in the key loop: S = Q K^T by
//     mma.sync.m16n8k16 (Q's A fragments in registers for the unit, rows
//     past the group zero and never stored; K by ldmatrix from the
//     swizzled stage, key x D, so no transpose), the row max and sum over
//     the four lanes of a quad, O += P V with P from the S accumulators
//     and V by ldmatrix.trans.  p keeps f32 precision (kDecPSplit): P V
//     runs twice, on hi = bf16(p) and lo = bf16(p - hi).  Where the group
//     has at most 8 query heads (ROWS 8) rows 8-15 skip the softmax.
//   - At a unit's end the warps combine their (m, l, O) through shared
//     memory (two barriers of the consumer warps a unit) and write o =
//     O / max(l, 1e-30), or, when the cache is split, f32 partials (m, l,
//     unnormalised O) that flash_decode_combine_kernel merges.
//   - Split-KV: the wrapper splits the cache (kernel.decode_splits, whole
//     128-key blocks) only when the units would not fill the card, so small
//     batches keep every SM streaming.
//   bk is not used by this kernel (its blocks are 128 keys; the splits are
//   whole blocks); Skv need not be a multiple of 128.  TMA row coordinates
//   are 32-bit: B*Hkv*Skv above INT32_MAX is refused.
//
//   bf16 at D 32 and fp32 at D 32, 64 and 128 ("cuda_cores"):
//   flash_decode_core_kernel, the tensor-core kernel's shape on the CUDA
//   cores.  The products stay f32 FFMAs (no TF32: the fp32 tolerance and p's
//   f32 precision are kept); at about 2 FLOP a byte the kernel is bound by
//   the bytes of K and V, so the design keeps every SM streaming them.
//   - A unit is (b, KV head, chunk of up to G = 4 or 8 of its query heads,
//     split); persistent CTAs (one per SM) walk the units, and the wrapper
//     splits the cache (kernel.decode_splits, whole 128-key blocks) where
//     the units would not fill the card, merged by the combine kernel.
//   - One producer thread keeps bulk copies (cp.async.bulk) of 64-key K and
//     V blocks in flight, into a K and a V ring of 3 to 12 stages (192 KB
//     together), with full and empty mbarriers apart.  A unit's keys are
//     one contiguous run of each tensor, so a block is one copy of 64·D
//     elements: no tensor map, no 32-bit row coordinate.
//   - n consumer warps (6 where the ring has 6 or 12 stages, 3 at fp32
//     D 128; DecCore::kConsumers) take whole blocks in turn (warp w the
//     blocks w, w + n, ...), each with its own running max, sum and O, with
//     no CTA barrier in the key loop.  Scores: lane i holds keys i and
//     i + 32 of the block and runs one FFMA chain per (head, key) over the
//     16-byte chunks of the row, q from shared memory; each lane starts at
//     another chunk, so the 8 lanes of a shared-memory phase read 8 bank
//     groups.  The row max over the warp's shuffles, p to a per-warp
//     buffer, then O += P V with lane i owning D/32 columns of every head.
//   - At a unit's end the warps combine their (m, l, O) through shared
//     memory (two barriers of the consumer warps a unit) and write o = O /
//     max(l, 1e-30), or the f32 partials (m, l, unnormalised O).
//   Offsets: a block's address is computed once in 64 bits by the
//   producer; everything in the key loop indexes shared memory.
//
// Every launcher has a plain C interface for ctypes, launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch
// (or a negative code of its own, see flash_error_string).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr float kMinDenom = 1e-30f;

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

// ---------------------------------------------------------------------------
// bf16 at (128, 128), D 64 and 128: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kFaThreads = 384;       // a producer and two consumer warpgroups
constexpr int kFaBlock = 128;         // query rows of a CTA (64 a consumer), keys of a KV block
constexpr int kFaBoxBytes = kFaBlock * kSwizzleCols * 2;  // one swizzled (128 x 64) TMA box
constexpr int kFaStages = 2;          // depth of the K and V rings
constexpr bool kPingPong = true;      // the consumers take turns on the tensor cores
constexpr bool kIntraOverlap = true;  // a block's softmax overlaps the previous block's P V
constexpr bool kRescaleInTurn = true; // O's correction runs under the next Q K^T
constexpr bool kQInRegs = true;       // Q K^T takes Q from registers, not shared memory
constexpr int kSmemLimit = 232448;    // dynamic shared memory a CTA may opt into
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct FwdWgmma {
  static constexpr int kBoxes = D / kSwizzleCols;        // TMA boxes of a row block
  static constexpr int kTileBytes = kBoxes * kFaBoxBytes;  // Q, or one K or V block
  static constexpr int kBars = 2 + 4 * kFaStages;        // Q full and empty; K and V full and empty
  // Q, the rings, 1024 bytes of slack to align them to the swizzle's period,
  // the mbarriers
  static constexpr int kSmem = (1 + 2 * kFaStages) * kTileBytes + 1024 + 8 * kBars;
  static_assert(D == 64 || D == 128, "wgmma forward head dim");
  static_assert(kFaStages >= 2 && kSmem <= kSmemLimit, "shared memory");
};

// S (64 x 128 fp32 fragment, 64 registers a thread) = or += A (smem) * B (smem);
// both K-major (imm-trans-b = 0); scale-d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
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
      "}, %64, %65, p, 1, 1, 0, 0;\n"
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

// d (64 x 64 fp32 fragment, 32 registers a thread) += A (registers: four
// bf16 pairs a thread, the m16n8k16 A layout per warp) * B (smem: K-major
// for TransB 0, MN-major for TransB 1); scale-d 0 overwrites d
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TransB));
}

// d (64 x 128 fp32 fragment, 64 registers a thread) += A (registers: four
// bf16 pairs a thread, the m16n8k16 A layout per warp) * B (smem: K-major
// for TransB 0, MN-major for TransB 1); scale-d 0 overwrites d
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TransB));
}

// barrier `id` over the 256 consumer threads: wait, or arrive without waiting
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(256) : "memory");
}
__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(256) : "memory");
}

// keep the compiler from moving register work on a wgmma operand across a
// wgmma wait: the tensor cores read and write these registers asynchronously
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for one consumer's 64 query rows and a block of 128 keys: Q and
// K both K-major, D/64 swizzled boxes of 128 rows (16 KB) each; a k16 step
// is 32 bytes along a swizzled row
template <int D>
__device__ __forceinline__ void qk_gemm(float (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk / 4) * kFaBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128(s, smem_desc(q + step, 16, 1024), smem_desc(k + step, 16, 1024), kk > 0);
  }
}

// The same with Q in registers (this consumer's 64 rows as D/16 m16n8k16
// A fragments a warp, qf from load_q), so only K is read from shared memory
template <int D>
__device__ __forceinline__ void qk_gemm(float (&s)[64], const uint32_t (&qf)[D / 16][4],
                                        uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_n128<0>(s, qf[kk], smem_desc(k + (kk / 4) * kFaBoxBytes + (kk % 4) * 32, 16, 1024),
                     kk > 0);
}

// Q's A fragments from the swizzled Q tile, by ldmatrix: lane l reads row
// l % 16 of its warp's 16 rows, 16-byte chunk l / 16 of the k step, which
// the 128-byte swizzle puts at chunk ^ (row % 8) of the row
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4], uint32_t sq, int first_row) {
  const int lane = threadIdx.x & 31;
  const int row = first_row + (threadIdx.x / 32 % 4) * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int chunk = (kk % 4) * 2 + (lane >> 4);
    ldmatrix_x4(qf[kk], sq + (kk / 4) * kFaBoxBytes + row * 128 + ((chunk ^ (row & 7)) << 4));
  }
}

// O += P V: P in registers (pack_p), V MN-major through the transpose-B
// mode, its 64-wide column boxes 16 KB apart (leading offset), 8-key groups
// 1024 bytes apart; a k16 step is 16 keys, 2048 bytes
template <int D>
__device__ __forceinline__ void pv_gemm(float (&o)[D / 2], const uint32_t (&p)[8][4], uint32_t v) {
#pragma unroll
  for (int t = 0; t < kFaBlock / 16; ++t) {
    const uint64_t db = smem_desc(v + t * 2048, kFaBoxBytes, 1024);
    if constexpr (D == 64)
      wgmma_rs_n64<1>(o, p[t], db, 1);
    else
      wgmma_rs_n128<1>(o, p[t], db, 1);
  }
}

// The S accumulator as P's A fragments, rounded to bf16.  Register 4j+e of
// an m64nN fp32 fragment holds row 16*warp + lane/4 (+8 for e >= 2), column
// 8j + 2*(lane%4) + (e&1); the A fragment of k step t is the m16n8k16 one
// of each warp: {row r, cols 2q, 2q+1}, {r+8, same}, {r, +8}, {r+8, +8} of
// keys 16t.., i.e. accumulator n8 tiles 2t and 2t+1.
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[t][i] = pack_bf16(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);
}

// One block's online softmax in the exp2 domain, in place: s (raw Q K^T)
// becomes p = 2^(s c - m) with c = scale * log2 e and m the running row max
// of s c; l keeps the thread's partial row sums of the unrounded p (summed
// over a row's four lanes once, in the epilogue); corr is each row's
// 2^(m_old - m).  kMask: keys past key_lim[r] get the reference's finite
// NEG_INF (a row that sees no key then averages the block, as the mma.sync
// kernel and the TPU kernel do).
template <bool kMask>
__device__ __forceinline__ void softmax_block(float (&s)[64], float (&m)[2], float (&l)[2],
                                              float (&corr)[2], float c, int key0,
                                              const int (&key_lim)[2]) {
  const int lane = threadIdx.x & 31;
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * (lane & 3) + (e & 1);
        s[4 * j + e] = key > key_lim[e >> 1] ? kNegInf : s[4 * j + e] * c;
      }
  }
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], kMask ? mx[r] : mx[r] * c);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * j + e];
      x = kMask ? ex2(x - m[e >> 1]) : ex2(fmaf(x, c, -m[e >> 1]));
      sum[e >> 1] += x;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// O scaled by each row's softmax correction: register 4j+e holds row e >> 1
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i >> 1) & 1];
}

// The tiles (b*Hq + h, q block) in the order the persistent CTAs take them:
// heavy (late) causal q blocks first, the heads of one q block side by side
// (a KV head's query heads share its K and V in L2)
__device__ __forceinline__ void fwd_tile(int t, int bh_count, int nqb, int& bh, int& qb) {
  qb = nqb - 1 - t / bh_count;
  bh = t % bh_count;
}

template <int D>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v, bf16* __restrict__ O, int B,
                       int Hq, int Hkv, int Sq, int Skv, float c, int causal) {
  using T = FwdWgmma<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                               // [boxes][128][64], swizzled
  const uint32_t sk = sq + T::kTileBytes;                 // [stages][boxes][128][64]
  const uint32_t sv = sk + kFaStages * T::kTileBytes;     // [stages][boxes][128][64]
  const uint32_t bars = sv + kFaStages * T::kTileBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + kFaStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 + 2 * kFaStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (2 + 3 * kFaStages + s); };

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh_count = B * Hq, nqb = Sq / kFaBlock, tiles = bh_count * nqb;
  const int off = Skv - Sq;
  // KV blocks 0..n-1 of q block qb; with Sq and Skv multiples of 128, only
  // block n-1 of a causal call is cut by the mask
  auto kv_blocks = [&](int qb) {
    return last_kv_block(causal, qb, kFaBlock, kFaBlock, Skv / kFaBlock, off) + 1;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);  // the producer's arrive.expect_tx
    mbar_init(q_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < kFaStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else on the warpgroup for the whole kernel: the roles never
  // reconverge, so setmaxnreg takes effect.  Every role walks the same
  // tiles (t = blockIdx.x, + gridDim.x, ...) and counts the same KV blocks
  // (it), which index the ring and give each mbarrier's phase.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0, ti = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int bh, qb;
        fwd_tile(t, bh_count, nqb, bh, qb);
        const int n = kv_blocks(qb);
        if (n <= 0) continue;
        const int b = bh / Hq, kvh = (bh % Hq) / (Hq / Hkv);
        const int kv_row = (b * Hkv + kvh) * Skv;
        mbar_wait(q_empty, (ti & 1) ^ 1);  // the last tile's Q K^T are done
        mbar_arrive_expect_tx(q_full, T::kTileBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_2d(sq + x * kFaBoxBytes, &tma_q, x * kSwizzleCols, bh * Sq + qb * kFaBlock,
                      q_full);
        for (int j = 0; j < n; ++j, ++it) {
          const int s = it % kFaStages, ph = (it / kFaStages) & 1;
          const int row = kv_row + j * kFaBlock;
          mbar_wait(k_empty(s), ph ^ 1);
          mbar_arrive_expect_tx(k_full(s), T::kTileBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x)
            tma_load_2d(sk + s * T::kTileBytes + x * kFaBoxBytes, &tma_k, x * kSwizzleCols, row,
                        k_full(s));
          mbar_wait(v_empty(s), ph ^ 1);
          mbar_arrive_expect_tx(v_full(s), T::kTileBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x)
            tma_load_2d(sv + s * T::kTileBytes + x * kFaBoxBytes, &tma_v, x * kSwizzleCols, row,
                        v_full(s));
        }
        ++ti;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cons = wg - 1;  // query rows 64*cons .. 64*cons+63 of a q block
    const int warp = tid / 32, lane = tid % 32;
    const uint32_t q = sq + cons * 64 * 128;  // this consumer's 64 rows of each Q box
    // named barriers 1 and 2: consumer 0's and consumer 1's turn to issue
    const int mine = 1 + cons, theirs = 2 - cons;
    float o[D / 2], s[64], m[2], l[2], corr[2];
    uint32_t p[8][4], qf[D / 16][4];
    int it = 0, ti = 0;
    bool started = false;

    // only the last block of a causal call runs the mask code
#define SOFTMAX(j)                                                          \
  if (causal && (j) == n - 1)                                               \
    softmax_block<true>(s, m, l, corr, c, (j) * kFaBlock, key_lim);         \
  else                                                                      \
    softmax_block<false>(s, m, l, corr, c, (j) * kFaBlock, key_lim)
#define RELEASE(bar) \
  if (lane == 0) mbar_arrive(bar)
#define QK(stage)                                      \
  if constexpr (kQInRegs)                              \
    qk_gemm<D>(s, qf, sk + (stage) * T::kTileBytes);   \
  else                                                 \
    qk_gemm<D>(s, q, sk + (stage) * T::kTileBytes)

    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int bh, qb;
      fwd_tile(t, bh_count, nqb, bh, qb);
      const int n = kv_blocks(qb);
      const int row = qb * kFaBlock + cons * 64 + warp * 16 + lane / 4;  // the thread's first row
      const int key_lim[2] = {row + off, row + 8 + off};
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

      if (n > 0) {
        if (kPingPong && cons == 1 && !started) consumers_arrive(1);  // consumer 0 goes first
        started = true;
        mbar_wait(q_full, ti & 1);
        if (kQInRegs) {  // Q in registers for the whole tile: its buffer is free at once
          load_q<D>(qf, sq, cons * 64);
          __syncwarp();
          RELEASE(q_empty);
        }
        // block 0: S only
        const int s0 = it % kFaStages;
        mbar_wait(k_full(s0), (it / kFaStages) & 1);
        if (kPingPong) consumers_sync(mine);
        wgmma_fence();
        QK(s0);
        wgmma_commit();
        if (kPingPong) consumers_arrive(theirs);
        wgmma_wait<0>();
        fence_regs(s);
        RELEASE(k_empty(s0));
        if (!kQInRegs && n == 1) RELEASE(q_empty);
        SOFTMAX(0);
        pack_p(s, p);
        // block j: S_j and P_{j-1} V_{j-1} in one turn on the tensor cores,
        // then S_j's softmax while P V still runs (and the other consumer's
        // turn begins)
        for (int j = 1; j < n; ++j) {
          const int st = (it + j) % kFaStages, pst = (it + j - 1) % kFaStages;
          mbar_wait(k_full(st), ((it + j) / kFaStages) & 1);
          mbar_wait(v_full(pst), ((it + j - 1) / kFaStages) & 1);
          if (kPingPong) consumers_sync(mine);
          wgmma_fence();
          QK(st);
          wgmma_commit();
          if (kRescaleInTurn) {  // block j-1's correction, before its P V adds in
            rescale(o, corr);
            wgmma_fence();
          }
          pv_gemm<D>(o, p, sv + pst * T::kTileBytes);
          wgmma_commit();
          if (kPingPong) consumers_arrive(theirs);
          if (kIntraOverlap)
            wgmma_wait<1>();
          else
            wgmma_wait<0>();
          fence_regs(s);
          RELEASE(k_empty(st));
          if (!kQInRegs && j == n - 1) RELEASE(q_empty);
          SOFTMAX(j);
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(p);
          RELEASE(v_empty(pst));
          if (!kRescaleInTurn) rescale(o, corr);
          pack_p(s, p);
        }
        // the last block's P V
        const int lst = (it + n - 1) % kFaStages;
        mbar_wait(v_full(lst), ((it + n - 1) / kFaStages) & 1);
        if (kPingPong) consumers_sync(mine);
        if (kRescaleInTurn) rescale(o, corr);
        wgmma_fence();
        pv_gemm<D>(o, p, sv + lst * T::kTileBytes);
        wgmma_commit();
        if (kPingPong) consumers_arrive(theirs);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        RELEASE(v_empty(lst));
        it += n;
        ++ti;
      }

      // o / max(l, 1e-30), rounded to bf16, stored from registers while the
      // producer already loads the next tile
      bf16* og = O + ((int64_t)bh * Sq + row) * D + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float denom = fmaxf(l[r], kMinDenom);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)r * 8 * D + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
      }
    }
#undef QK
#undef RELEASE
#undef SOFTMAX
    // consumer 1 arrived once ahead, at its first turn: consumer 0 takes
    // that arrival here, so both barriers end balanced
    if (kPingPong && cons == 0 && started) consumers_sync(1);
  }
}

// One consumer's P V for a given P (fp32 64 x 128, row-major) and V (one
// TMA block of 128 keys), through the kernel's own pack_p and pv_gemm;
// O (fp32 64 x D) from the accumulator's registers.  A card check of the
// register-A (RS) fragment layout, not part of any entry point.
template <int D>
__global__ void __launch_bounds__(128)
flash_pv_probe_kernel(const __grid_constant__ CUtensorMap tma_v, const float* __restrict__ P,
                      float* __restrict__ O) {
  using T = FwdWgmma<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sv = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = sv + T::kTileBytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, T::kTileBytes);
    for (int x = 0; x < T::kBoxes; ++x)
      tma_load_2d(sv + x * kFaBoxBytes, &tma_v, x * kSwizzleCols, 0, bar);
  }
  const int row = warp * 16 + lane / 4, col = 2 * (lane & 3);
  float s[64], o[D / 2];
  uint32_t p[8][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * j + e] = P[(row + 8 * (e >> 1)) * kFaBlock + 8 * j + col + (e & 1)];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  pack_p(s, p);
  mbar_wait(bar, 0);
  wgmma_fence();
  pv_gemm<D>(o, p, sv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[(row + 8 * (e >> 1)) * D + 8 * j + col + (e & 1)] = o[4 * j + e];
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

// ---------------------------------------------------------------------------
// decode, bf16 at D 64 and 128: a TMA ring under warp-local mma.sync consumers
// ---------------------------------------------------------------------------
constexpr int kDecBlock = 128;        // keys of a ring stage: the rows of one TMA box
constexpr int kDecBoxBytes = kDecBlock * kSwizzleCols * 2;
constexpr int kDecRows = 16;          // query rows of a unit: one m16n8k16 A tile
constexpr int kDecConsumers = 3;      // consumer warps; warp 0 is the producer
constexpr int kDecStagesD64 = 6;      // K and V stages of the rings at D 64 (16 KB a block)
constexpr int kDecStagesD128 = 3;     // at D 128 (32 KB a block)
constexpr int kDecPSplit = 1;         // P V on bf16(p) and on bf16(p - bf16(p)): p keeps f32 precision
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct DecTma {
  static constexpr int kBoxes = D / kSwizzleCols;           // TMA boxes of a block
  static constexpr int kTileBytes = kBoxes * kDecBoxBytes;  // one K or V block
  static constexpr int kStages = D == 64 ? kDecStagesD64 : kDecStagesD128;
  static constexpr int kRedFloats = kDecConsumers * kDecRows * (D + 2);  // each warp's O, m, l
  static constexpr int kBars = 4 * kStages;                 // K and V full and empty
  // the rings, 1024 bytes of slack to align them to the swizzle's period,
  // the warps' partials, the mbarriers
  static constexpr int kSmem = 2 * kStages * kTileBytes + 1024 + 4 * kRedFloats + 8 * kBars;
  static_assert(D == 64 || D == 128, "tensor-core decode head dim");
  static_assert(kStages >= 1 && kSmem <= kSmemLimit, "shared memory");
  // block it sits in stage it % kStages and goes to warp it % kDecConsumers:
  // so each stage serves one warp, which waits on its phases in order (a
  // parity wait more than one phase ahead of its mbarrier would pass)
  static_assert(kStages % kDecConsumers == 0, "each stage must serve one consumer warp");
};

// barrier 1 over the consumer warps
__device__ __forceinline__ void dec_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kDecConsumers * 32) : "memory");
}

// Q's m16n8k16 A fragments for the unit's query rows (rows past ng zero):
// register i of k step t holds row lane/4 + 8 (i & 1), columns 16t +
// 2 (lane % 4) + 8 (i >> 1) and the next
template <int D>
__device__ __forceinline__ void dec_load_q(uint32_t (&qf)[D / 16][4], const bf16* q, int ng) {
  const int lane = threadIdx.x & 31, qr = lane >> 2, qc = 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < D / 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qr + (i & 1) * 8, col = 16 * t + qc + (i >> 1) * 8;
      qf[t][i] = row < ng ? *reinterpret_cast<const uint32_t*>(q + row * D + col) : 0u;
    }
}

// the byte offset of (row, 16-byte chunk) in a block of D/64 swizzled boxes:
// chunk c of a row sits at c ^ (row % 8) of its box's 128-byte row
__device__ __forceinline__ uint32_t dec_swz(int row, int chunk) {
  return (chunk >> 3) * kDecBoxBytes + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

// S (16 rows x 128 keys) = Q K^T: n8 tile n holds keys 8n..8n+7; K by
// ldmatrix, the x4 matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys
// 8-15, d 0-7), (keys 8-15, d 8-15) of each 16 keys
template <int D>
__device__ __forceinline__ void dec_qk(float (&s)[16][4], const uint32_t (&qf)[D / 16][4],
                                       uint32_t k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int t = 0; t < D / 16; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t kf[4];
      const int key = 16 * j + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(kf, k + dec_swz(key, 2 * t + ((lane >> 3) & 1)));
      mma_bf16(s[2 * j], qf[t], kf[0], kf[1]);
      mma_bf16(s[2 * j + 1], qf[t], kf[2], kf[3]);
    }
}

// One block's online softmax in the exp2 domain, in place: s (raw Q K^T)
// becomes p = 2^(s c - m), m the running row max of s c; l keeps the
// thread's partial row sums (summed over the quad at the unit's end); corr
// is 2^(m_old - m).  Register e of tile n is key key0 + 8n + 2 (lane % 4)
// + (e & 1), row lane/4 + 8 (e >> 1); keys at or past `end` get the finite
// NEG_INF.  ROWS 8: rows 8-15 hold no query head and are skipped.
template <int ROWS>
__device__ __forceinline__ void dec_softmax(float (&s)[16][4], float (&m)[2], float (&l)[2],
                                            float (&corr)[2], float c, int key0, int end) {
  constexpr int R = ROWS / 8;
  const bool mask = key0 + kDecBlock > end;  // only the cache's last block can be cut
  const int key = key0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        float x = s[n][e] * c;
        if (mask && key + 8 * n + (e & 1) >= end) x = kNegInf;
        s[n][e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[n][e] = ex2(s[n][e] - m_new);
        sum += s[n][e];
      }
    l[r] = l[r] * corr[r] + sum;
  }
  if (R == 1) corr[1] = 1.f;
}

// hi = bf16(x0, x1) and lo = bf16 of what hi leaves out
__device__ __forceinline__ void split_p(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// O (16 rows x D) += P V: the S accumulators of n8 tiles 2t and 2t+1 are
// the A fragment of k step t (keys 16t..16t+15); V by ldmatrix.trans, the
// x4 matrices (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7, d 8-15),
// (keys 8-15, d 8-15) of each 16 columns
template <int D, int ROWS>
__device__ __forceinline__ void dec_pv(float (&o)[D / 8][4], const float (&s)[16][4], uint32_t v) {
  const int lane = threadIdx.x & 31;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = lane >> 4;
#pragma unroll
  for (int t = 0; t < kDecBlock / 16; ++t) {
    uint32_t hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
    split_p(s[2 * t][0], s[2 * t][1], hi[0], lo[0]);
    split_p(s[2 * t + 1][0], s[2 * t + 1][1], hi[2], lo[2]);
    if (ROWS > 8) {
      split_p(s[2 * t][2], s[2 * t][3], hi[1], lo[1]);
      split_p(s[2 * t + 1][2], s[2 * t + 1][3], hi[3], lo[3]);
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, v + dec_swz(16 * t + lrow, 2 * j + lcol));
      mma_bf16(o[2 * j], hi, vf[0], vf[1]);
      mma_bf16(o[2 * j + 1], hi, vf[2], vf[3]);
      if (kDecPSplit) {
        mma_bf16(o[2 * j], lo, vf[0], vf[1]);
        mma_bf16(o[2 * j + 1], lo, vf[2], vf[3]);
      }
    }
  }
}

// grid: at most one CTA per SM, each walking the units u = blockIdx.x,
// + gridDim.x, ...; unit u is (b*Hkv + kvh, split, chunk), chunk fastest,
// and covers query heads kvh*group + 16*chunk .. (at most 16) and the
// 128-key blocks [sp*nb/splits, (sp+1)*nb/splits) of the cache.  splits 1:
// o is written; else part (B, Hq, splits, D + 2) f32 gets each unit's
// unnormalised O, its row max m of the scaled scores and its sum l.
template <int D, int ROWS>
__global__ void __launch_bounds__((1 + kDecConsumers) * 32, 1)
flash_decode_tma_kernel(const __grid_constant__ CUtensorMap tma_k,
                        const __grid_constant__ CUtensorMap tma_v, const bf16* __restrict__ Q,
                        bf16* __restrict__ O, float* __restrict__ part, int B, int Hq, int Hkv,
                        int Skv, int splits, float c) {
  using T = DecTma<D>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;             // [stages][boxes][128][64], swizzled
  const uint32_t sv = sk + S * T::kTileBytes;             // [stages][boxes][128][64], swizzled
  const uint32_t sred = sv + S * T::kTileBytes;           // [warps][16][D + 2] f32
  float* red = reinterpret_cast<float*>(smem_raw + (sred - raw));
  const uint32_t bars = sred + 4 * T::kRedFloats;
  auto k_full = [&](int s) { return bars + 8u * s; };
  auto v_full = [&](int s) { return bars + 8u * (S + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 * S + s); };
  auto v_empty = [&](int s) { return bars + 8u * (3 * S + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = Hq / Hkv, chunks = (group + kDecRows - 1) / kDecRows;
  const int nb = (Skv + kDecBlock - 1) / kDecBlock;
  const int units = B * Hkv * chunks * splits;
  auto unit = [&](int u, int& bkv, int& sp, int& ch, int& kb0, int& kb1) {
    ch = u % chunks;
    sp = u / chunks % splits;
    bkv = u / chunks / splits;
    kb0 = (int)((int64_t)sp * nb / splits);
    kb1 = (int)((int64_t)(sp + 1) * nb / splits);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);   // the producer's arrive.expect_tx
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 1);  // lane 0 of the warp that took the block
      mbar_init(v_empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // every role walks the same units and counts the same blocks (it), which
  // index the rings, give each mbarrier's phase and name the consumer warp
  if (warp == 0) {
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int bkv, sp, ch, kb0, kb1;
        unit(u, bkv, sp, ch, kb0, kb1);
        for (int kb = kb0; kb < kb1; ++kb, ++it) {
          const int st = it % S, ph = (it / S) & 1;
          const int row = bkv * Skv + kb * kDecBlock;
          mbar_wait(k_empty(st), ph ^ 1);
          mbar_arrive_expect_tx(k_full(st), T::kTileBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x)
            tma_load_2d(sk + st * T::kTileBytes + x * kDecBoxBytes, &tma_k, x * kSwizzleCols, row,
                        k_full(st));
          mbar_wait(v_empty(st), ph ^ 1);
          mbar_arrive_expect_tx(v_full(st), T::kTileBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x)
            tma_load_2d(sv + st * T::kTileBytes + x * kDecBoxBytes, &tma_v, x * kSwizzleCols, row,
                        v_full(st));
        }
      }
    }
    return;
  }

  const int cw = warp - 1, qr = lane >> 2, qc = 2 * (lane & 3);
  float* mine = red + cw * kDecRows * (D + 2);
  float s[16][4], o[D / 8][4], m[2], l[2], corr[2];
  uint32_t qf[D / 16][4];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int bkv, sp, ch, kb0, kb1;
    unit(u, bkv, sp, ch, kb0, kb1);
    const int b = bkv / Hkv, kvh = bkv % Hkv;
    const int ng = min(kDecRows, group - ch * kDecRows);
    const int64_t h0 = (int64_t)b * Hq + kvh * group + ch * kDecRows;  // the unit's first b*Hq + h
    dec_load_q<D>(qf, Q + h0 * D, ng);
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    for (int kb = kb0; kb < kb1; ++kb, ++it) {
      if (it % kDecConsumers != cw) continue;
      const int st = it % S, ph = (it / S) & 1;
      mbar_wait(k_full(st), ph);
      dec_qk<D>(s, qf, sk + st * T::kTileBytes);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(st));
      dec_softmax<ROWS>(s, m, l, corr, c, kb * kDecBlock, Skv);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
      mbar_wait(v_full(st), ph);
      dec_pv<D, ROWS>(o, s, sv + st * T::kTileBytes);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(st));
    }

    // the warps' (m, l, O) of the unit's rows into shared memory, then
    // merged: o = sum_w 2^(m_w - M) O_w / max(sum_w 2^(m_w - M) l_w, 1e-30)
#pragma unroll
    for (int r = 0; r < ROWS / 8; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = qr + 8 * r;
      if (row < ng) {
        float* dst = mine + row * (D + 2);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          dst[8 * n + qc] = o[n][2 * r];
          dst[8 * n + qc + 1] = o[n][2 * r + 1];
        }
        if (qc == 0) {
          dst[D] = m[r];
          dst[D + 1] = l[r];
        }
      }
    }
    dec_consumers_sync();
    for (int i = threadIdx.x - 32; i < ng * D; i += kDecConsumers * 32) {
      const int row = i / D, d = i % D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kDecConsumers; ++w) mx = fmaxf(mx, red[(w * kDecRows + row) * (D + 2) + D]);
      float acc = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kDecConsumers; ++w) {
        const float* src = red + (w * kDecRows + row) * (D + 2);
        const float f = ex2(src[D] - mx);
        acc += f * src[d];
        sum += f * src[D + 1];
      }
      if (splits == 1) {
        O[(h0 + row) * D + d] = __float2bfloat16_rn(acc / fmaxf(sum, kMinDenom));
      } else {
        float* dst = part + ((h0 + row) * splits + sp) * (D + 2);
        dst[d] = acc;
        if (d == 0) {
          dst[D] = mx * kLn2;  // the natural-log domain of the plain version
          dst[D + 1] = sum;
        }
      }
    }
    dec_consumers_sync();  // the partials' buffer is free for the next unit
  }
}

// o (rows, D) in OutT (bf16 or f32) from the partials (rows, splits, D + 2)
// f32 of the splits: m = max_s m_s, o = sum_s e^(m_s - m) O_s /
// max(sum_s e^(m_s - m) l_s, 1e-30).  One warp a row, lanes along D.
template <typename OutT>
__global__ void __launch_bounds__(128)
flash_decode_combine_kernel(const float* __restrict__ part, OutT* __restrict__ O, int rows, int D,
                            int splits) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* p = part + (int64_t)row * splits * (D + 2);
  float mx = kNegInf;
  for (int sp = lane; sp < splits; sp += 32) mx = fmaxf(mx, p[sp * (D + 2) + D]);
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
  float sum = 0.f;
  for (int sp = lane; sp < splits; sp += 32)
    sum += expf(p[sp * (D + 2) + D] - mx) * p[sp * (D + 2) + D + 1];
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
  const float denom = fmaxf(sum, kMinDenom);
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += expf(p[sp * (D + 2) + D] - mx) * p[sp * (D + 2) + d];
    from_float(acc / denom, O + (int64_t)row * D + d);
  }
}

// ---------------------------------------------------------------------------
// decode on the CUDA cores (fp32 at D 32, 64 and 128; bf16 at D 32): a ring
// of bulk copies under warp-local FFMA consumers
// ---------------------------------------------------------------------------
constexpr int kCoreBlock = 64;           // keys of a ring stage (Skv is a multiple of 64)
constexpr int kCoreMaxConsumers = 6;     // consumer warps at most; warp 0 is the producer
constexpr int kCoreRingBytes = 196608;   // the K and V rings together
constexpr int kCoreMaxStages = 12;

template <typename T, int D, int G>
struct DecCore {
  static constexpr int kVec = 16 / sizeof(T);   // elements of one 16-byte chunk
  static constexpr int kChunks = D / kVec;      // chunks of a key row
  static constexpr int kCols = D / 32;          // columns of O a lane owns in P V
  static constexpr int kTileBytes = kCoreBlock * D * sizeof(T);  // one K or V block
  static constexpr int kFit = kCoreRingBytes / (2 * kTileBytes);
  static constexpr int kRing = kFit < kCoreMaxStages ? kFit : kCoreMaxStages;  // 3, 6 or 12
  // small blocks (D 32: 4 or 8 KB) leave a warp more work per byte than
  // large ones: as many consumers as divide the ring, up to kCoreMaxConsumers
  static constexpr int kConsumers = kRing % kCoreMaxConsumers == 0 ? kCoreMaxConsumers
                                    : kRing % 3 == 0 && kCoreMaxConsumers > 3 ? 3 : 1;
  static constexpr int kStages = kRing / kConsumers * kConsumers;
  static constexpr int kQFloats = G * D;                       // the unit's q, in f32
  static constexpr int kPFloats = kConsumers * G * kCoreBlock;  // each warp's p of a block
  static constexpr int kRedFloats = kConsumers * G * (D + 2);   // each warp's O, m, l
  static constexpr int kBars = 4 * kStages;                    // K and V full and empty
  static constexpr int kSmem =
      2 * kStages * kTileBytes + 4 * (kQFloats + kPFloats + kRedFloats) + 8 * kBars;
  static_assert(D % 32 == 0 && kChunks >= 4, "head dim");
  // block it sits in stage it % kStages and goes to warp it % kConsumers, so
  // each stage serves one warp, which waits on its phases in order
  static_assert(kStages >= kConsumers && kStages % kConsumers == 0, "stages");
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// barrier 1 over the N consumer warps
template <int N>
__device__ __forceinline__ void core_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N * 32) : "memory");
}

// N consecutive f32 of shared memory, 16-byte aligned
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z; x[4 * i + 3] = v.w;
  }
}

// the N columns of a V row that a lane owns, as f32
template <int N, typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&x)[N]) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
    load_f32<N>(reinterpret_cast<const float*>(p), x);
  } else if constexpr (sizeof(T) == 4 && N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_float(p[j]);
  }
}

// grid: at most one CTA per SM, each walking the units u = blockIdx.x,
// + gridDim.x, ...; unit u is (b*Hkv + kvh, split, chunk), chunk fastest,
// and covers query heads kvh*group + G*chunk .. (at most G) and the keys of
// the split's 128-key blocks [sp*nb/splits, (sp+1)*nb/splits), in blocks of
// 64.  splits 1: o is written; else part (B, Hq, splits, D + 2) f32 gets each
// unit's unnormalised O, its max m of the scaled scores and its sum l.
template <typename T, int D, int G>
__global__ void __launch_bounds__((1 + DecCore<T, D, G>::kConsumers) * 32, 1)
flash_decode_core_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                         T* __restrict__ O, float* __restrict__ part, int B, int Hq, int Hkv,
                         int Skv, int splits, float c) {
  using C = DecCore<T, D, G>;
  constexpr int S = C::kStages;
  constexpr int NC = C::kConsumers;
  constexpr int KPL = kCoreBlock / 32;  // keys of a block each lane scores
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);              // [stages][64][D]
  T* sv = sk + S * kCoreBlock * D;                      // [stages][64][D]
  float* sq = reinterpret_cast<float*>(sv + S * kCoreBlock * D);  // [G][D]
  float* sp = sq + C::kQFloats;                         // [warps][G][64]
  float* red = sp + C::kPFloats;                        // [warps][G][D + 2]
  const uint32_t bars = smem_u32(red + C::kRedFloats);
  auto k_full = [&](int s) { return bars + 8u * s; };
  auto v_full = [&](int s) { return bars + 8u * (S + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 * S + s); };
  auto v_empty = [&](int s) { return bars + 8u * (3 * S + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = Hq / Hkv, chunks = (group + G - 1) / G;
  const int nb = (Skv + 127) / 128;  // the 128-key blocks the splits are made of
  const int units = B * Hkv * chunks * splits;
  auto unit = [&](int u, int& bkv, int& spl, int& ch, int& kb0, int& kb1) {
    ch = u % chunks;
    spl = u / chunks % splits;
    bkv = u / chunks / splits;
    kb0 = min(Skv, (int)((int64_t)spl * nb / splits) * 128) / kCoreBlock;
    kb1 = min(Skv, (int)((int64_t)(spl + 1) * nb / splits) * 128) / kCoreBlock;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);   // the producer's arrive.expect_tx
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 1);  // lane 0 of the warp that took the block
      mbar_init(v_empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // every role walks the same units and counts the same blocks (it), which
  // index the rings, give each mbarrier's phase and name the consumer warp
  if (warp == 0) {
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int bkv, spl, ch, kb0, kb1;
        unit(u, bkv, spl, ch, kb0, kb1);
        for (int kb = kb0; kb < kb1; ++kb, ++it) {
          const int st = it % S, ph = (it / S) & 1;
          const int64_t row = (int64_t)bkv * Skv + kb * kCoreBlock;
          mbar_wait(k_empty(st), ph ^ 1);
          mbar_arrive_expect_tx(k_full(st), C::kTileBytes);
          bulk_load(smem_u32(sk + st * kCoreBlock * D), K + row * D, C::kTileBytes, k_full(st));
          mbar_wait(v_empty(st), ph ^ 1);
          mbar_arrive_expect_tx(v_full(st), C::kTileBytes);
          bulk_load(smem_u32(sv + st * kCoreBlock * D), V + row * D, C::kTileBytes, v_full(st));
        }
      }
    }
    return;
  }

  const int cw = warp - 1;
  float* pw = sp + cw * G * kCoreBlock;
  // the chunk a lane reads first: the 8 lanes of a shared-memory phase then
  // read 8 different bank groups of their 8 key rows
  const int rot = C::kChunks >= 8 ? lane : lane / (8 / C::kChunks);
  float s[G][KPL], o[G][C::kCols], m[G], l[G];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int bkv, spl, ch, kb0, kb1;
    unit(u, bkv, spl, ch, kb0, kb1);
    const int b = bkv / Hkv, kvh = bkv % Hkv;
    const int ng = min(G, group - ch * G);
    const int64_t h0 = (int64_t)b * Hq + kvh * group + ch * G;  // the unit's first b*Hq + h
    for (int i = threadIdx.x - 32; i < G * D; i += NC * 32)
      sq[i] = i / D < ng ? to_float(Q[h0 * D + i]) : 0.f;
    core_consumers_sync<NC>();  // q is in; the last unit's combine has read red
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) o[g][j] = 0.f;
    }

    for (int kb = kb0; kb < kb1; ++kb, ++it) {
      if (it % NC != cw) continue;
      const int st = it % S, ph = (it / S) & 1;
      // scores of keys lane + 32 j, one FFMA chain per (head, key)
      mbar_wait(k_full(st), ph);
      const T* kt = sk + st * kCoreBlock * D;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < KPL; ++j) s[g][j] = 0.f;
#pragma unroll
      for (int t = 0; t < C::kChunks; ++t) {
        const int cc = (t + rot) % C::kChunks;
        float kv[KPL][C::kVec];
#pragma unroll
        for (int j = 0; j < KPL; ++j) load_vec(kt + (lane + 32 * j) * D + cc * C::kVec, kv[j]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float qv[C::kVec];
          load_f32<C::kVec>(sq + g * D + cc * C::kVec, qv);
#pragma unroll
          for (int j = 0; j < KPL; ++j)
#pragma unroll
            for (int e = 0; e < C::kVec; ++e) s[g][j] = fmaf(qv[e], kv[j][e], s[g][j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(st));
      // the block's online softmax in the exp2 domain; p to this warp's buffer
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          s[g][j] *= c;
          mx = fmaxf(mx, s[g][j]);
        }
#pragma unroll
        for (int w = 16; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        const float m_new = fmaxf(m[g], mx);
        const float corr = ex2(m[g] - m_new);
        m[g] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const float p = ex2(s[g][j] - m_new);
          pw[g * kCoreBlock + lane + 32 * j] = p;
          sum += p;
        }
        l[g] = l[g] * corr + sum;  // this lane's keys; summed over the warp at the unit's end
#pragma unroll
        for (int j = 0; j < C::kCols; ++j) o[g][j] *= corr;
      }
      __syncwarp();
      // O += P V: lane owns columns kCols*lane .. of every head
      mbar_wait(v_full(st), ph);
      const T* vt = sv + st * kCoreBlock * D + lane * C::kCols;
#pragma unroll 2
      for (int k4 = 0; k4 < kCoreBlock; k4 += 4) {
        float p4[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g) load_f32<4>(pw + g * kCoreBlock + k4, p4[g]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float vv[C::kCols];
          load_cols<C::kCols>(vt + (k4 + e) * D, vv);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < C::kCols; ++j) o[g][j] = fmaf(p4[g][e], vv[j], o[g][j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(st));
    }

    // the warps' (m, l, O) into shared memory, then merged: o = sum_w
    // 2^(m_w - M) O_w / max(sum_w 2^(m_w - M) l_w, 1e-30)
    float* mine = red + cw * G * (D + 2);
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) l[g] += __shfl_xor_sync(0xffffffffu, l[g], w);
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) mine[g * (D + 2) + lane * C::kCols + j] = o[g][j];
      if (lane == 0) {
        mine[g * (D + 2) + D] = m[g];
        mine[g * (D + 2) + D + 1] = l[g];
      }
    }
    core_consumers_sync<NC>();
    for (int i = threadIdx.x - 32; i < ng * D; i += NC * 32) {
      const int g = i / D, d = i % D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < NC; ++w) mx = fmaxf(mx, red[(w * G + g) * (D + 2) + D]);
      float acc = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < NC; ++w) {
        const float* src = red + (w * G + g) * (D + 2);
        const float f = ex2(src[D] - mx);
        acc += f * src[d];
        sum += f * src[D + 1];
      }
      if (splits == 1) {
        from_float(acc / fmaxf(sum, kMinDenom), O + (h0 + g) * D + d);
      } else {
        float* dst = part + ((h0 + g) * splits + spl) * (D + 2);
        dst[d] = acc;
        if (d == 0) {
          dst[D] = mx * kLn2;  // the natural-log domain of the plain version
          dst[D + 1] = sum;
        }
      }
    }
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

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                     int Sq, int Skv, float scale, int causal, cudaStream_t s) {
  using T = FwdWgmma<D>;
  // TMA row coordinates are 32-bit
  if ((int64_t)B * Hq * Sq > INT32_MAX || (int64_t)B * Hkv * Skv > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  // q, k and v as row-major (B*H*S, D) matrices in (128 rows, 64 columns) boxes
  CUtensorMap mq, mk, mv;
  int rc = encode_bf16(&mq, q, B * Hq * Sq, D, kFaBlock);
  if (rc == 0) rc = encode_bf16(&mk, k, B * Hkv * Skv, D, kFaBlock);
  if (rc == 0) rc = encode_bf16(&mv, v, B * Hkv * Skv, D, kFaBlock);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kern = flash_fwd_wgmma_kernel<D>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = B * Hq * (Sq / kFaBlock);
  const int grid = tiles < sms ? tiles : sms;  // persistent: at most one CTA per SM
  kern<<<grid, kFaThreads, T::kSmem, s>>>(mq, mk, mv, static_cast<bf16*>(o), B, Hq, Hkv, Sq, Skv,
                                          scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D, int G>
int launch_decode_core(const void* q, const void* k, const void* v, void* o, void* part, int B,
                       int Hq, int Hkv, int Skv, int splits, float scale, cudaStream_t s) {
  using C = DecCore<T, D, G>;
  const int nb = (Skv + 127) / 128;
  const int chunks = (Hq / Hkv + G - 1) / G;
  // whole 64-key blocks; each split holds at least one 128-key block
  if (Skv % kCoreBlock || splits < 1 || splits > nb || (splits > 1 && part == nullptr) ||
      (int64_t)B * Hkv * chunks * splits > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kern = flash_decode_core_kernel<T, D, G>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int units = B * Hkv * chunks * splits;
  const int ctas = units < sms ? units : sms;  // persistent: at most one CTA per SM
  kern<<<ctas, (1 + C::kConsumers) * 32, C::kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(part), B, Hq, Hkv, Skv, splits, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D, int ROWS>
int launch_decode_tma(const void* q, const void* k, const void* v, void* o, void* part, int B,
                      int Hq, int Hkv, int Skv, int splits, float scale, cudaStream_t s) {
  using T = DecTma<D>;
  const int nb = (Skv + kDecBlock - 1) / kDecBlock;
  const int chunks = (Hq / Hkv + kDecRows - 1) / kDecRows;
  // TMA row coordinates are 32-bit; each split holds at least one block
  if ((int64_t)B * Hkv * Skv > INT32_MAX || (int64_t)B * Hkv * chunks * splits > INT32_MAX ||
      splits < 1 || splits > nb || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  // k and v as row-major (B*Hkv*Skv, D) matrices in (128 rows, 64 columns) boxes
  CUtensorMap mk, mv;
  int rc = encode_bf16(&mk, k, B * Hkv * Skv, D, kDecBlock);
  if (rc == 0) rc = encode_bf16(&mv, v, B * Hkv * Skv, D, kDecBlock);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kern = flash_decode_tma_kernel<D, ROWS>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int units = B * Hkv * chunks * splits;
  const int grid = units < sms ? units : sms;  // persistent: at most one CTA per SM
  kern<<<grid, (1 + kDecConsumers) * 32, T::kSmem, s>>>(
      mk, mv, static_cast<const bf16*>(q), static_cast<bf16*>(o), static_cast<float*>(part), B, Hq,
      Hkv, Skv, splits, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_decode_tma(const void* q, const void* k, const void* v, void* o, void* part, int B,
                        int Hq, int Hkv, int Skv, int splits, float scale, cudaStream_t s) {
  if (Hq / Hkv <= 8)  // every query head of a unit in rows 0-7
    return launch_decode_tma<D, 8>(q, k, v, o, part, B, Hq, Hkv, Skv, splits, scale, s);
  return launch_decode_tma<D, 16>(q, k, v, o, part, B, Hq, Hkv, Skv, splits, scale, s);
}

// units of up to 4 query heads where the group has at most 4, else of 8
template <typename T, int D>
int dispatch_decode_core(const void* q, const void* k, const void* v, void* o, void* part, int B,
                         int Hq, int Hkv, int Skv, int splits, float scale, cudaStream_t s) {
  if (Hq / Hkv <= 4)
    return launch_decode_core<T, D, 4>(q, k, v, o, part, B, Hq, Hkv, Skv, splits, scale, s);
  return launch_decode_core<T, D, 8>(q, k, v, o, part, B, Hq, Hkv, Skv, splits, scale, s);
}

}  // namespace

extern "C" {

// The forward kernel for elem_bytes 2 (bf16) or 4 (fp32), head dim D and
// tile (bq, bk): kRouteWgmma for bf16 (128, 128) at D 64 and 128,
// kRouteMmaSync for the other bf16 kernels (D 32 at both tiles, D 64 and
// 128 at (64, 64)), kRouteCudaCores for fp32 (D 32 or 64, both tiles),
// kRouteNone for anything not instantiated.
enum { kRouteNone = 0, kRouteWgmma = 1, kRouteMmaSync = 2, kRouteCudaCores = 3, kRouteTmaMma = 4 };

int flash_fwd_route(int elem_bytes, int D, int bq, int bk) {
  const bool big = bq == 128 && bk == 128, small = bq == 64 && bk == 64;
  if (!big && !small) return kRouteNone;
  if (elem_bytes == 2) {
    if (big && (D == 64 || D == 128)) return kRouteWgmma;
    if (D == 32 || D == 64 || D == 128) return kRouteMmaSync;
  } else if (elem_bytes == 4 && (D == 32 || D == 64)) {
    return kRouteCudaCores;
  }
  return kRouteNone;
}

// launches the kernel flash_fwd_route names; a combination it does not
// name returns cudaErrorInvalidValue without launching
int flash_fwd_launch(int elem_bytes, const void* q, const void* k, const void* v, void* o, int B,
                     int Hq, int Hkv, int Sq, int Skv, int D, int bq, int bk, float scale,
                     int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool big = bq == 128;
#define FWD(KERN, ...) KERN<__VA_ARGS__>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, s)
  switch (flash_fwd_route(elem_bytes, D, bq, bk)) {
    case kRouteWgmma:
      return D == 64 ? FWD(launch_fwd_wgmma, 64) : FWD(launch_fwd_wgmma, 128);
    case kRouteMmaSync:
      if (D == 32) return big ? FWD(launch_fwd_bf16, 128, 128, 32) : FWD(launch_fwd_bf16, 64, 64, 32);
      return D == 64 ? FWD(launch_fwd_bf16, 64, 64, 64) : FWD(launch_fwd_bf16, 64, 64, 128);
    case kRouteCudaCores:
      if (D == 32) return big ? FWD(launch_fwd_f32, 128, 128, 32) : FWD(launch_fwd_f32, 64, 64, 32);
      return big ? FWD(launch_fwd_f32, 128, 128, 64) : FWD(launch_fwd_f32, 64, 64, 64);
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// the RS fragment probe: p fp32 (64, 128), v bf16 (128, D), o fp32 (64, D),
// D 64 or 128, all contiguous on the card
int flash_pv_probe_launch(const void* p, const void* v, void* o, int D, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  CUtensorMap mv;
  if (int rc = encode_bf16(&mv, v, kFaBlock, D, kFaBlock)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pp = static_cast<const float*>(p);
  auto* po = static_cast<float*>(o);
  if (D == 64) {
    constexpr int smem = FwdWgmma<64>::kTileBytes + 1024 + 8;
    if (int err = set_smem(flash_pv_probe_kernel<64>, smem)) return err;
    flash_pv_probe_kernel<64><<<1, 128, smem, s>>>(mv, pp, po);
  } else {
    constexpr int smem = FwdWgmma<128>::kTileBytes + 1024 + 8;
    if (int err = set_smem(flash_pv_probe_kernel<128>, smem)) return err;
    flash_pv_probe_kernel<128><<<1, 128, smem, s>>>(mv, pp, po);
  }
  return (int)cudaGetLastError();
}

// The decode kernel for elem_bytes 2 (bf16) or 4 (fp32) and head dim D:
// kRouteTmaMma for bf16 at D 64 and 128, kRouteCudaCores for bf16 at D 32
// and fp32 at D 32, 64 and 128, kRouteNone for anything not instantiated.
int flash_decode_route(int elem_bytes, int D) {
  if (elem_bytes == 2 && (D == 64 || D == 128)) return kRouteTmaMma;
  if ((elem_bytes == 2 || elem_bytes == 4) && (D == 32 || D == 64 || D == 128))
    return kRouteCudaCores;
  return kRouteNone;
}

// launches the kernel flash_decode_route names on splits (1 up to the
// cache's 128-key blocks) parts of the cache; splits 1 writes o, more write
// part (B, Hq, splits, D + 2) f32 for flash_decode_combine_launch.  Both
// kernels pick their own key blocks; kRouteCudaCores needs Skv a multiple
// of 64.  Anything else returns
// cudaErrorInvalidValue without launching.
int flash_decode_launch(int elem_bytes, const void* q, const void* k, const void* v, void* o,
                        void* part, int B, int Hq, int Hkv, int Skv, int D, int splits,
                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEC(T, HD) \
  return dispatch_decode_core<T, HD>(q, k, v, o, part, B, Hq, Hkv, Skv, splits, scale, s)
  switch (flash_decode_route(elem_bytes, D)) {
    case kRouteTmaMma:
      if (D == 64) return dispatch_decode_tma<64>(q, k, v, o, part, B, Hq, Hkv, Skv, splits, scale, s);
      return dispatch_decode_tma<128>(q, k, v, o, part, B, Hq, Hkv, Skv, splits, scale, s);
    case kRouteCudaCores:
      if (elem_bytes == 2) DEC(bf16, 32);
      if (D == 32) DEC(float, 32);
      if (D == 64) DEC(float, 64);
      DEC(float, 128);
  }
#undef DEC
  return (int)cudaErrorInvalidValue;
}

// o (rows, D) from part (rows, splits, D + 2) f32, all on the card: o bf16
// for out_bytes 2, f32 for 4; anything else returns cudaErrorInvalidValue
int flash_decode_combine_launch(const void* part, void* o, int rows, int D, int splits,
                                int out_bytes, void* stream) {
  if (rows < 1 || D < 1 || splits < 1 || (out_bytes != 2 && out_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bytes == 2)
    flash_decode_combine_kernel<bf16><<<(rows + 3) / 4, 128, 0, s>>>(p, static_cast<bf16*>(o), rows,
                                                                      D, splits);
  else
    flash_decode_combine_kernel<float><<<(rows + 3) / 4, 128, 0, s>>>(p, static_cast<float*>(o),
                                                                       rows, D, splits);
  return (int)cudaGetLastError();
}

const char* flash_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused the operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
