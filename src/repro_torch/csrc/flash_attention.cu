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
// argument; a few ulp), and
// the bf16 forward rounds p to bf16 for the tensor-core P V product while l
// sums the unrounded p.  The fp32 kernels and the decode kernels keep p in
// f32 (the tensor-core decode as the sum of two bf16 parts, the fp32
// forward as the sum of two TF32 parts).
//
// Head dims: 32, 64, 80, 96 and 128 in both dtypes, forward and decode (the
// repo's configs: 64 mostly, 128 mixtral-8x7b, qwen1.5 and others, 96
// phi3-mini-3.8b, 80 zamba2-2.7b; 32 their reduced forms).
//
// flash_attention_fwd
//   Replaces repro/kernels/flash_attention/kernel.py:
//   make_flash_attention(B, Hq, Hkv, Sq, Skv, D, bq, bk, causal) (grid
//   (B*Hq, Sq/bq, Skv/bk), KV blocks innermost, f32 scratch).  The TPU's
//   sequential KV axis becomes a loop inside the CTA over KV blocks of BK
//   rows.  Causal: the mask keeps key j for query i when j <= i + (Skv -
//   Sq), and KV block kb is skipped when kb*BK > qb*BQ + BQ - 1 + (Skv -
//   Sq), as the reference's pl.when does.  Heavy (late) query blocks are
//   scheduled first.  A row that sees no key (Skv < Sq) gets the
//   reference's value at the tile (rbq, rbk) the caller asked for, which
//   need not be the tile that runs: the mean of V over the keys of the KV
//   blocks the reference computes for its q block, or 0 where it computes
//   none (every key of those blocks masked to the finite NEG_INF, so p = 1).
//   (rbq, rbk) must be multiples of the tile that runs, as every config of
//   the reference's space is of (128, 128).
//
//   bf16 at (128, 128), every head dim: flash_fwd_wgmma_kernel, Hopper's
//   own form (FA3).  Bound at the model's prefill by the tensor cores (4·D
//   flops a kept (query, key) pair at 989 TFLOP/s) and, at D = 64, as much
//   by the exponentials: the MUFU unit does 16 ex2 a clock per SM, about
//   as long as the tensor-core bound.  So the design keeps both busy at
//   once.  Persistent CTAs (one per SM) of three warpgroups walk the tiles
//   (b*Hq + h, q block of 128 rows), heavy causal q blocks first, in
//   rounds of a tile a CTA that alternate direction (so every CTA's KV
//   blocks come out level); the producer loads the next tile's Q and K
//   while the consumers finish the last one.
//   - Warpgroup 0 is the producer: one thread issues TMA loads of the Q
//     block (once a tile) and of K and V blocks of 128 keys into a ring of
//     kFaStages stages, each tensor viewed as a row-major (B*H*S, D) matrix
//     in (128 x 64) boxes, 128-byte swizzled.  K and V have full and empty
//     mbarriers of their own, so Q K^T starts before V lands.  It drops to
//     40 registers (setmaxnreg); the consumers rise to 232.
//   - D that 64 does not divide (32, 80, 96) is padded to whole boxes in
//     shared memory only (FwdWgmma::kWidth: 64 at D 32, 128 at 80 and 96):
//     the tensor maps keep the true width D, so TMA zero-fills the columns
//     past it, and each box's full bytes still count toward its mbarrier's
//     transaction.  Q K^T runs only the D / 16 k steps of real columns, and
//     P V is wgmma at N = D (kPvExactWidth; m64n32k16, m64n80k16,
//     m64n96k16), whose transpose-B read takes the second 64-column box in
//     its first D - 64 columns only (the 128-byte MN-major atom is 64
//     columns wide; the card's P V probe and tests check that a partial
//     one reads right).  Over the padded width instead, the zero columns of V
//     give zero columns of O at 1.6x the P V work at D 80, 1.33x at 96:
//     3-4 % slower in the ablation (PERF.md).  The epilogue stores the D
//     columns, row stride D.
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
//   bf16 at (64, 64), every head dim: the same kernel at KV blocks of 64
//   keys (FwdWgmma<D, 64>).  The two
//   consumers of a CTA take two adjacent 64-row q blocks of one (b, h), so
//   both read one ring of 64-key K and V blocks in (64 x 64) boxes
//   (kFa64Stages deep: a stage is half the bytes); consumer 0 stops a
//   block before consumer 1 on the causal diagonal and takes its turns
//   with nothing to issue while consumer 1 finishes, so both keep the same
//   number of turns, and each masks only its own last block.  S is wgmma
//   m64n64k16 (32 accumulators a thread), P V m64nDk16 over 4 k steps; a
//   block's row max and sum are trees (kTreeReduce).  Halving the block
//   halves the masked work on the diagonal and doubles the per-block
//   costs (waits, turns, row reductions): at the model's prefill the
//   per-block costs win: the kernel is slower than the (128, 128) one
//   (PERF.md, section 6 row 10).  kFa64Pair off gives each CTA one consumer and a
//   ring of its own, two CTAs an SM, for the ablation.
//
//   fp32 (both tiles, every head dim): flash_fwd_tf32_kernel, fp32-accurate
//   products on the TF32 tensor cores in three passes, S = Qhi Khi + Qhi Klo
//   + Qlo Khi and O += Phi Vhi + Phi Vlo + Plo Vhi, each operand split in
//   registers: hi = tf32(x), the nearest TF32 value (cvt.rna.tf32.f32's
//   bits, by two integer operations: the cvt on hi measured 11 % slower),
//   and lo = x - hi, whose TF32 bits the MMA reads.  Bound at the model's fp32
//   prefill by those passes: 3 x 4·D flops a kept (query, key) pair at
//   494.7 TFLOP/s, 0.41x one fp32 pass on the CUDA cores at 67 (whose
//   FFMAs, and a transposed K and P in shared memory, the kernel before
//   this one used).  It reads about a third of that bound: the passes
//   themselves take most of the time (without the splits the kernel still
//   takes 0.82-0.84x its time, with one pass 0.49x), on mma.sync, which is not
//   Hopper's full-rate wgmma path.  The design:
//   - One CTA a tile (b*Hq + h, 16 x n query rows), heavy causal tiles
//     first (persistent CTAs, one per SM, were 0.8-12.5 % slower in every
//     ablation run, PERF.md).  One producer thread (its warpgroup's
//     registers go to the consumers) keeps TMA loads of fp32 K and V
//     blocks of 64 keys in flight into a ring of 2 stages (4 were 0.4-3.6 %
//     slower), (64 x 32) boxes, 128-byte swizzled, with full and
//     empty mbarriers for K and V apart.  K and V sit in shared memory
//     once, in fp32, key x D: nothing is transposed or split in memory.
//   - n consumer warps (8; 4 at D 128, where their Q would not fit), each
//     owning 16 query rows (FA2), all on the same blocks, with no CTA
//     barrier in the key loop.  mma.sync.m16n8k8 tf32: Q's A fragments are
//     split once a tile into the warp's own slots of shared memory (two
//     16-byte loads a k step); a K B fragment (K[key][d], d = t, t + 4)
//     is one 32-bit load, the swizzle's chunk ^ row keeping the 32 lanes
//     on 32 banks; P comes from the S accumulators, whose columns 2t and
//     2t + 1 serve as the A fragment's k = t and t + 4 when V's B fragment
//     takes rows 2t and 2t + 1 (again conflict-free under the swizzle).
//   - The tensor cores' sums truncate, so the small products (lo·hi +
//     hi·lo) go into an accumulator of their own, a block's P V into a
//     fresh one, and both are added in fp32 on the CUDA cores
//     (kT32SmallApart): O = O·corr + (hi sum + small sum), the
//     reference's order.
//   - Each warp stops at its own last row's diagonal, in 64-key blocks,
//     within the reference's KV blocks of its q block at (bq, bk): the
//     keys past it are masked to NEG_INF and add exactly nothing.  A row
//     that sees no key at all (Skv < Sq) reads the reference's blocks.
//   - Offsets: 32-bit TMA coordinates and shared-memory indices; Q and O
//     from a 64-bit tile base.
//
//   The ablation (kernels/flash_attention/ablate.py --part fwd32) times one
//   pass, 4 consumer warps, 4 stages, the small products summed in, lo
//   rounded, hi by cvt.rna, probes that drop a piece, and the kernel before
//   this one from --base.
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
//   bf16 at D 32, 80 and 96 and fp32 at every head dim ("cuda_cores"):
//   flash_decode_core_kernel, the tensor-core kernel's shape on the CUDA
//   cores.  The products stay f32 FFMAs (no TF32: the fp32 tolerance and p's
//   f32 precision are kept); at about 2 FLOP a byte the kernel is bound by
//   the bytes of K and V, so the design keeps every SM streaming them.
//   - A unit is (b, KV head, chunk of up to G = 4 or 8 of its query heads,
//     split); persistent CTAs (one per SM) walk the units, and the wrapper
//     splits the cache (kernel.decode_splits, whole 128-key blocks) where
//     the units would not fill the card, merged by the combine kernel.
//   - One producer thread keeps bulk copies (cp.async.bulk) of 64-key K and
//     V blocks in flight, into a K and a V ring of 3, 6 or 12 stages (at
//     most 192 KB together), with full and empty mbarriers apart.  A unit's keys are
//     one contiguous run of each tensor, so a block is one copy of 64·D
//     elements: no tensor map, no 32-bit row coordinate.
//   - n consumer warps (6 where the ring has 6 or 12 stages, 3 at fp32
//     D 80, 96 and 128; DecCore::kConsumers) take whole blocks in turn (warp w the
//     blocks w, w + n, ...), each with its own running max, sum and O, with
//     no CTA barrier in the key loop.  Scores: lane i holds keys i and
//     i + 32 of the block and runs one FFMA chain per (head, key) over the
//     16-byte chunks of the row, q from shared memory; each lane starts at
//     another chunk, so the 8 lanes of a shared-memory phase read 8 bank
//     groups.  The row max over the warp's shuffles, p to a per-warp
//     buffer, then O += P V with lane i owning columns D/32 i .. D/32 i +
//     D/32 - 1 of every head, or, where 32 does not divide D (80), columns
//     i + 32 j, those at or past D masked.
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

// ---------------------------------------------------------------------------
// bf16 at (128, 128) and (64, 64), every head dim: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kFaStages = 2;          // depth of the K and V rings at (128, 128)
constexpr int kFa64Stages = 3;        // at (64, 64), whose stages are half the bytes
constexpr bool kFa64Pair = true;      // at (64, 64) a CTA's two consumers share one ring
constexpr bool kPingPong = true;      // the consumers take turns on the tensor cores
constexpr bool kIntraOverlap = true;  // a block's softmax overlaps the previous block's P V
constexpr bool kRescaleInTurn = true; // O's correction runs under the next Q K^T
constexpr bool kQInRegs = true;       // Q K^T takes Q from registers, not shared memory
constexpr bool kPvExactWidth = true;  // P V at N = D, not over D padded to whole boxes
constexpr bool kSnakeTiles = true;    // the persistent CTAs' tile rounds alternate direction
constexpr bool kTreeReduce = true;    // at (64, 64) a block's row max and sum as trees, not chains
constexpr int kSmemLimit = 232448;    // dynamic shared memory a CTA may opt into
constexpr int kSmemPerSm = 233472;    // shared memory of an SM (1 KB of it reserved a CTA)
constexpr float kLog2e = 1.4426950408889634f;

// The forward at KV blocks of BK keys (128 or 64).  A CTA is a producer
// warpgroup and kCons consumer warpgroups of 64 query rows each, which take
// the kRows = 64 kCons rows of a tile (its q block at (128, 128), its two
// adjacent q blocks at (64, 64)) and share one ring of K and V blocks.  D
// is padded to whole 64-column boxes in shared memory only: the tensor
// maps keep the true width, so TMA zero-fills the columns past D (and the
// transaction still counts each box's full bytes).  kFa64Pair off: one
// consumer a CTA at (64, 64), two CTAs an SM, each with its own ring.
template <int D, int BK>
struct FwdWgmma {
  static constexpr int kCons = BK == 128 || kFa64Pair ? 2 : 1;
  static constexpr int kCtasPerSm = 3 - kCons;
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kRows = 64 * kCons;                // query rows of a tile
  static constexpr bool kTurns = kPingPong && kCons == 2;  // ping-pong between the consumers
  // the consumers' registers after setmaxnreg (the producer keeps 40)
  static constexpr int kConsRegs = kCons == 2 ? 232 : 216;
  static constexpr int kBoxes = (D + kSwizzleCols - 1) / kSwizzleCols;  // TMA boxes of a row block
  static constexpr int kWidth = kBoxes * kSwizzleCols;   // D padded to whole boxes
  static constexpr int kN = kPvExactWidth ? D : kWidth;   // P V's N, O's columns
  static constexpr int kQBoxBytes = kRows * 128;          // one swizzled (kRows x 64) box
  static constexpr int kKvBoxBytes = BK * 128;            // one swizzled (BK x 64) box
  static constexpr int kQBytes = kBoxes * kQBoxBytes;     // Q
  static constexpr int kKvBytes = kBoxes * kKvBoxBytes;   // one K or V block
  // Q, 1024 bytes of slack to align the boxes to the swizzle's period, the
  // Q mbarriers, and as many stages (with their mbarriers) as are asked
  // for and fit kCtasPerSm CTAs an SM
  static constexpr int kCap = kCtasPerSm == 1 ? kSmemLimit : kSmemPerSm / 2 - 1024;
  static constexpr int kWant = BK == 128 ? kFaStages : kFa64Stages;
  static constexpr int kFit = (kCap - kQBytes - 1024 - 16) / (2 * kKvBytes + 32);
  static constexpr int kStages = kWant < kFit ? kWant : kFit;
  static constexpr int kBars = 2 + 4 * kStages;  // Q full and empty; K and V full and empty
  static constexpr int kSmem = kQBytes + 2 * kStages * kKvBytes + 1024 + 8 * kBars;
  static_assert(D % 16 == 0 && D <= 128, "wgmma forward head dim");
  static_assert(BK == 128 || BK == 64, "wgmma forward KV block");
  static_assert(kStages >= 2 && kSmem <= kCap, "shared memory");
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

// S (64 x 64 fp32 fragment, 32 registers a thread) = or += A (smem) * B (smem),
// as wgmma_ss_n128: Q K^T at (64, 64) with Q from shared memory (kQInRegs off)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// d (64 x 32 fp32 fragment, 16 registers a thread) += A (registers) * B
// (smem), as wgmma_rs_n64: P V at N = D 32 (kPvExactWidth)
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TransB));
}

// d (64 x 80 fp32 fragment, 40 registers a thread) += A (registers) * B
// (smem), as wgmma_rs_n64: P V at N = D 80 (kPvExactWidth)
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TransB));
}

// d (64 x 96 fp32 fragment, 48 registers a thread) += A (registers) * B
// (smem), as wgmma_rs_n64: P V at N = D 96 (kPvExactWidth)
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for one consumer's 64 query rows and a block of BK keys: Q and
// K both K-major, in swizzled boxes of 64 columns (Q's kQBox bytes, K's
// BK x 128); a k16 step is 32 bytes along a swizzled row, and only the
// D / 16 steps of real columns run (the zero padding past D is never read)
template <int D, int BK, int kQBox>
__device__ __forceinline__ void qk_gemm(float (&s)[BK / 2], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = smem_desc(q + (kk / 4) * kQBox + col, 16, 1024);
    const uint64_t db = smem_desc(k + (kk / 4) * BK * 128 + col, 16, 1024);
    if constexpr (BK == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
}

// The same with Q in registers (this consumer's 64 rows as D/16 m16n8k16
// A fragments a warp, qf from load_q), so only K is read from shared memory
template <int D, int BK>
__device__ __forceinline__ void qk_gemm(float (&s)[BK / 2], const uint32_t (&qf)[D / 16][4],
                                        uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = smem_desc(k + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
    if constexpr (BK == 128)
      wgmma_rs_n128<0>(s, qf[kk], db, kk > 0);
    else
      wgmma_rs_n64<0>(s, qf[kk], db, kk > 0);
  }
}

// Q's A fragments from the swizzled Q tile (boxes of kQBox bytes), by
// ldmatrix: lane l reads row l % 16 of its warp's 16 rows, 16-byte chunk
// l / 16 of the k step, which the 128-byte swizzle puts at chunk ^ (row % 8)
// of the row
template <int D, int kQBox>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4], uint32_t sq, int first_row) {
  const int lane = threadIdx.x & 31;
  const int row = first_row + (threadIdx.x / 32 % 4) * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int chunk = (kk % 4) * 2 + (lane >> 4);
    ldmatrix_x4(qf[kk], sq + (kk / 4) * kQBox + row * 128 + ((chunk ^ (row & 7)) << 4));
  }
}

// O += P V over a block of BK keys: P in registers (pack_p), V MN-major
// through the transpose-B mode, its 64-wide column boxes BK x 128 bytes
// apart (leading offset), 8-key groups 1024 bytes apart; a k16 step is 16
// keys, 2048 bytes.  N is FwdWgmma::kN: D, or D padded to whole boxes (V's
// zero columns give O zero columns, never stored)
template <int D, int BK>
__device__ __forceinline__ void pv_gemm(float (&o)[FwdWgmma<D, BK>::kN / 2],
                                        const uint32_t (&p)[BK / 16][4], uint32_t v) {
  constexpr int N = FwdWgmma<D, BK>::kN;
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) {
    const uint64_t db = smem_desc(v + t * 2048, BK * 128, 1024);
    if constexpr (N == 32)
      wgmma_rs_n32<1>(o, p[t], db, 1);
    else if constexpr (N == 64)
      wgmma_rs_n64<1>(o, p[t], db, 1);
    else if constexpr (N == 80)
      wgmma_rs_n80<1>(o, p[t], db, 1);
    else if constexpr (N == 96)
      wgmma_rs_n96<1>(o, p[t], db, 1);
    else
      wgmma_rs_n128<1>(o, p[t], db, 1);
  }
}

// The S accumulator (an m64nBK fp32 fragment) as P's A fragments, rounded
// to bf16.  Register 4j+e holds row 16*warp + lane/4 (+8 for e >= 2),
// column 8j + 2*(lane%4) + (e&1); the A fragment of k step t is the
// m16n8k16 one of each warp: {row r, cols 2q, 2q+1}, {r+8, same}, {r, +8},
// {r+8, +8} of keys 16t.., i.e. accumulator n8 tiles 2t and 2t+1.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[t][i] = pack_bf16(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);
}

// The largest (kSum: the sum) of row r's N/2 values in an m16 accumulator
// fragment s (register 4j+e holding row e >> 1), as a tree of N/2 - 1
// operations, log2(N/2) deep
template <int N, bool kSum>
__device__ __forceinline__ float row_tree(const float (&s)[N], int r) {
  float t[N / 4];
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    t[j] = kSum ? s[4 * j + 2 * r] + s[4 * j + 2 * r + 1]
                : fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
#pragma unroll
  for (int w = N / 8; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = kSum ? t[j] + t[j + w] : fmaxf(t[j], t[j + w]);
  return t[0];
}

// One block's online softmax in the exp2 domain, in place: s (raw Q K^T,
// N/4 n8 tiles of an m16 accumulator, register 4j+e holding row e >> 1,
// key 8j + 2*(lane%4) + (e&1)) becomes p = 2^(s c - m) with c = scale * log2 e and m the running row max
// of s c; l keeps the thread's partial row sums of the unrounded p (summed
// over a row's four lanes once, in the epilogue); corr is each row's
// 2^(m_old - m).  kMask: keys past key_lim[r] get the reference's finite
// NEG_INF (a row that sees no key then averages the keys of its blocks, as
// the TPU kernel does).
template <bool kMask, int N, bool kTree = false>
__device__ __forceinline__ void softmax_block(float (&s)[N], float (&m)[2], float (&l)[2],
                                              float (&corr)[2], float c, int key0,
                                              const int (&key_lim)[2]) {
  const int lane = threadIdx.x & 31;
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * (lane & 3) + (e & 1);
        s[4 * j + e] = key > key_lim[e >> 1] ? kNegInf : s[4 * j + e] * c;
      }
  }
  // kTree: the row max and sum as trees (row_tree); else as chains, the sum
  // beside the exponentials (a tree of 64 values spilled at (128, 128))
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};
  if constexpr (kTree) {
    mx[0] = row_tree<N, false>(s, 0);
    mx[1] = row_tree<N, false>(s, 1);
  } else {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], kMask ? mx[r] : mx[r] * c);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * j + e];
      x = kMask ? ex2(x - m[e >> 1]) : ex2(fmaf(x, c, -m[e >> 1]));
      if constexpr (!kTree) sum[e >> 1] += x;
    }
  if constexpr (kTree) {
    sum[0] = row_tree<N, true>(s, 0);
    sum[1] = row_tree<N, true>(s, 1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// The end of the keys that a causal row that sees no key (row + off < 0)
// averages: the end of the reference's KV blocks of its q block at the
// tile (rbq, rbk), or 0 where the reference computes none.  rbq and rbk
// are multiples of the tile that runs (the launchers refuse others), so the
// end is a whole number of the kernel's KV blocks, every key of which the
// mask sets to NEG_INF alike (p = 1).
__device__ __forceinline__ int no_key_end(int row, int Skv, int off, int rbq, int rbk) {
  const int lim = (row / rbq) * rbq + rbq - 1 + off;
  return lim < 0 ? 0 : min(Skv, (lim / rbk + 1) * rbk);
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

// The i-th tile (in fwd_tile's order) of this persistent CTA: round i of
// gridDim.x tiles, taken in reverse every other round (kSnakeTiles), so
// that with heavy tiles first each CTA's KV blocks come out level (a
// stride of gridDim.x left the busiest CTA 12.5 % over the mean at B 1 x
// 32 heads, 3 % at 4 x 32).  Past the last tile once it returns one >= the
// tile count.
__device__ __forceinline__ int cta_tile(int i) {
  const bool back = kSnakeTiles && (i & 1);
  return i * gridDim.x + (back ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// The KV blocks of BK keys that the 64 query rows r0 .. r0 + 63 read: all
// of them for a full call; causal, those up to the last row's diagonal or,
// where the rows see no key, the reference's blocks of their q block
// (no_key_end; Sq and Skv are multiples of 64 and rbq of 64, so the 64 rows
// all see a key or all see none, in one reference q block); none for rows
// past Sq (the second q block of a (64, 64) tile when Sq / 64 is odd)
template <int BK>
__device__ __forceinline__ int wgmma_blocks(int r0, int Sq, int Skv, int causal, int rbq,
                                            int rbk) {
  if (r0 >= Sq) return 0;
  const int off = Skv - Sq;
  const int n = last_kv_block(causal, r0 / 64, 64, BK, Skv / BK, off) + 1;
  return n > 0 ? n : no_key_end(r0, Skv, off, rbq, rbk) / BK;
}

template <int D, int BK>
__global__ void __launch_bounds__((FwdWgmma<D, BK>::kThreads), (FwdWgmma<D, BK>::kCtasPerSm))
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v, bf16* __restrict__ O, int B,
                       int Hq, int Hkv, int Sq, int Skv, int rbq, int rbk, float c, int causal) {
  using T = FwdWgmma<D, BK>;
  constexpr int S = T::kStages, NC = T::kCons;
  constexpr bool kTree = kTreeReduce && BK == 64;
  // kSame: both consumers read the tile's blocks.  At (128, 128) they read
  // the same ones: Sq, Skv and rbq are multiples of 128, so a tile's rows
  // all see a key or all see none, in one reference q block
  constexpr bool kSame = NC == 1 || BK == 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                       // [boxes][kRows][64], swizzled
  const uint32_t sk = sq + T::kQBytes;            // [stages][boxes][BK][64]
  const uint32_t sv = sk + S * T::kKvBytes;       // [stages][boxes][BK][64]
  const uint32_t bars = sv + S * T::kKvBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + S + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 + 2 * S + s); };
  auto v_empty = [&](int s) { return bars + 8u * (2 + 3 * S + s); };

  // the warpgroup; where the consumers' block counts differ it is broadcast
  // from lane 0 so the compiler knows it is uniform (a count it must treat
  // as divergent costs a warp sync before every named barrier, a check
  // before every shuffle and the uniform registers of the ring's addresses;
  // the ablation's "warpgroup index not broadcast"); where they cannot
  // differ the broadcast only costs (PERF.md)
  const int wg = kSame ? threadIdx.x / 128 : __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int bh_count = B * Hq, nqb = (Sq + T::kRows - 1) / T::kRows, tiles = bh_count * nqb;
  const int off = Skv - Sq;
  // the KV blocks of consumer `cons` in tile row block qb, and of the tile
  // (the most of its consumers', which the producer loads); neither depends
  // on the warpgroup
  auto cons_blocks = [&](int qb, int cons) {
    return wgmma_blocks<BK>(qb * T::kRows + cons * 64, Sq, Skv, causal, rbq, rbk);
  };
  auto tile_blocks = [&](int qb) {
    return kSame ? cons_blocks(qb, 0) : max(cons_blocks(qb, 0), cons_blocks(qb, 1));
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);  // the producer's arrive.expect_tx
    mbar_init(q_empty, 4 * NC);  // lane 0 of each consumer warp
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * NC);
      mbar_init(v_empty(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else on the warpgroup for the whole kernel: the roles never
  // reconverge, so setmaxnreg takes effect.  Every role walks the same
  // tiles (cta_tile) and counts the same KV blocks (it), which index the
  // ring and give each mbarrier's phase.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0, ti = 0;
      for (int i = 0, t = cta_tile(0); t < tiles; t = cta_tile(++i)) {
        int bh, qb;
        fwd_tile(t, bh_count, nqb, bh, qb);
        const int n = tile_blocks(qb);
        if (n <= 0) continue;
        const int b = bh / Hq, kvh = (bh % Hq) / (Hq / Hkv);
        const int kv_row = (b * Hkv + kvh) * Skv;
        mbar_wait(q_empty, (ti & 1) ^ 1);  // the last tile's Q K^T are done
        mbar_arrive_expect_tx(q_full, T::kQBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_2d(sq + x * T::kQBoxBytes, &tma_q, x * kSwizzleCols, bh * Sq + qb * T::kRows,
                      q_full);
        for (int j = 0; j < n; ++j, ++it) {
          const int s = it % S, ph = (it / S) & 1;
          const int row = kv_row + j * BK;
          mbar_wait(k_empty(s), ph ^ 1);
          mbar_arrive_expect_tx(k_full(s), T::kKvBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x)
            tma_load_2d(sk + s * T::kKvBytes + x * T::kKvBoxBytes, &tma_k, x * kSwizzleCols, row,
                        k_full(s));
          mbar_wait(v_empty(s), ph ^ 1);
          mbar_arrive_expect_tx(v_full(s), T::kKvBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x)
            tma_load_2d(sv + s * T::kKvBytes + x * T::kKvBoxBytes, &tma_v, x * kSwizzleCols, row,
                        v_full(s));
        }
        ++ti;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsRegs));
    const int cons = wg - 1;  // query rows 64*cons .. 64*cons+63 of a tile
    const int warp = tid / 32, lane = tid % 32;
    const uint32_t q = sq + cons * 64 * 128;  // this consumer's 64 rows of each Q box
    // named barriers 1 and 2: consumer 0's and consumer 1's turn to issue
    const int mine = 1 + cons, theirs = 2 - cons;
    float o[T::kN / 2], s[BK / 2], m[2], l[2], corr[2];
    uint32_t p[BK / 16][4], qf[D / 16][4];
    int it = 0, ti = 0;
    bool started = false;

    // only the last block of a causal call runs the mask code, or every
    // block where the rows see no key (each key masked: the mean of V over
    // the reference's blocks, wgmma_blocks)
#define SOFTMAX(j)                                                           \
  if (mask_all || (causal && (j) == n - 1))                                  \
    softmax_block<true, BK / 2, kTree>(s, m, l, corr, c, (j) * BK, key_lim); \
  else                                                                       \
    softmax_block<false, BK / 2, kTree>(s, m, l, corr, c, (j) * BK, key_lim)
#define RELEASE(bar) \
  if (lane == 0) mbar_arrive(bar)
#define QK(stage)                                                  \
  if constexpr (kQInRegs)                                          \
    qk_gemm<D, BK>(s, qf, sk + (stage) * T::kKvBytes);             \
  else                                                             \
    qk_gemm<D, BK, T::kQBoxBytes>(s, q, sk + (stage) * T::kKvBytes)

    for (int i = 0, t = cta_tile(0); t < tiles; t = cta_tile(++i)) {
      int bh, qb;
      fwd_tile(t, bh_count, nqb, bh, qb);
      const int r0 = qb * T::kRows + cons * 64;  // this consumer's first row
      const int nt = tile_blocks(qb), n = kSame ? nt : cons_blocks(qb, cons);
      // rows that see no key: mask every block.  Where both consumers walk the
      // tile's blocks it is read off the tile, not the consumer, so that the
      // compiler can prove it uniform (at (128, 128) a tile's rows all see a
      // key or all see none)
      const bool mask_all = causal && (kSame ? qb * T::kRows : r0) + off < 0;
      const int row = r0 + warp * 16 + lane / 4;  // the thread's first row
      const int key_lim[2] = {row + off, row + 8 + off};
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int i = 0; i < T::kN / 2; ++i) o[i] = 0.f;

      if (nt > 0) {
        if (T::kTurns && cons == 1 && !started) consumers_arrive(1);  // consumer 0 goes first
        started = true;
        mbar_wait(q_full, ti & 1);
        if (kQInRegs || n == 0) {  // Q in registers for the whole tile: its buffer is free at once
          if (n > 0) load_q<D, T::kQBoxBytes>(qf, sq, cons * 64);
          __syncwarp();
          RELEASE(q_empty);
        }
      }
      if (n > 0) {
        // block 0: S only
        const int s0 = it % S;
        mbar_wait(k_full(s0), (it / S) & 1);
        if (T::kTurns) consumers_sync(mine);
        wgmma_fence();
        QK(s0);
        wgmma_commit();
        if (T::kTurns) consumers_arrive(theirs);
        wgmma_wait<0>();
        fence_regs(s);
        RELEASE(k_empty(s0));
        if (!kQInRegs && n == 1) RELEASE(q_empty);
        SOFTMAX(0);
        pack_p<BK>(s, p);
        // block j: S_j and P_{j-1} V_{j-1} in one turn on the tensor cores,
        // then S_j's softmax while P V still runs (and the other consumer's
        // turn begins)
        for (int j = 1; j < n; ++j) {
          const int st = (it + j) % S, pst = (it + j - 1) % S;
          mbar_wait(k_full(st), ((it + j) / S) & 1);
          mbar_wait(v_full(pst), ((it + j - 1) / S) & 1);
          if (T::kTurns) consumers_sync(mine);
          wgmma_fence();
          QK(st);
          wgmma_commit();
          if (kRescaleInTurn) {  // block j-1's correction, before its P V adds in
            rescale(o, corr);
            wgmma_fence();
          }
          pv_gemm<D, BK>(o, p, sv + pst * T::kKvBytes);
          wgmma_commit();
          if (T::kTurns) consumers_arrive(theirs);
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
          pack_p<BK>(s, p);
        }
        // the last block's P V
        const int lst = (it + n - 1) % S;
        mbar_wait(v_full(lst), ((it + n - 1) / S) & 1);
        if (T::kTurns) consumers_sync(mine);
        if (kRescaleInTurn) rescale(o, corr);
        wgmma_fence();
        pv_gemm<D, BK>(o, p, sv + lst * T::kKvBytes);
        wgmma_commit();
        if (T::kTurns) consumers_arrive(theirs);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        RELEASE(v_empty(lst));
      }
      if (nt > 0) {
        // the tile's blocks past this consumer's last (consumer 0 stops a
        // block before consumer 1 on the causal diagonal at (64, 64)): wait
        // for each and release it, in a turn that issues nothing, so both
        // consumers take the tile's nt + 1 turns
        if constexpr (!kSame) {
        for (int j = n; j < nt; ++j) {
          const int st = (it + j) % S, ph = ((it + j) / S) & 1;
          mbar_wait(k_full(st), ph);
          mbar_wait(v_full(st), ph);
          if (T::kTurns) {
            consumers_sync(mine);
            consumers_arrive(theirs);
          }
          RELEASE(k_empty(st));
          RELEASE(v_empty(st));
        }
        if (T::kTurns && n == 0) {
          consumers_sync(mine);
          consumers_arrive(theirs);
        }
        }
        it += nt;
        ++ti;
      }

      // o / max(l, 1e-30), rounded to bf16, stored from registers while the
      // producer already loads the next tile: the D / 8 n8 tiles of real
      // columns, row stride D
      if (BK == 128 || NC == 1 || r0 < Sq) {  // rows past Sq: only a (64, 64) tile's second half
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
    }
#undef QK
#undef RELEASE
#undef SOFTMAX
    // consumer 1 arrived once ahead, at its first turn: consumer 0 takes
    // that arrival here, so both barriers end balanced
    if (T::kTurns && cons == 0 && started) consumers_sync(1);
  }
}

// One consumer's P V for a given P (fp32 64 x 128, row-major) and V (one
// TMA block of 128 keys, D columns zero-padded to whole boxes), through the
// kernel's own pack_p and pv_gemm; O (fp32 64 x D) from the accumulator's
// registers, its D real columns.  A card check of the
// register-A (RS) fragment layout, not part of any entry point.
template <int D>
__global__ void __launch_bounds__(128)
flash_pv_probe_kernel(const __grid_constant__ CUtensorMap tma_v, const float* __restrict__ P,
                      float* __restrict__ O) {
  using T = FwdWgmma<D, 128>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sv = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = sv + T::kKvBytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, T::kKvBytes);
    for (int x = 0; x < T::kBoxes; ++x)
      tma_load_2d(sv + x * T::kKvBoxBytes, &tma_v, x * kSwizzleCols, 0, bar);
  }
  const int row = warp * 16 + lane / 4, col = 2 * (lane & 3);
  float s[64], o[T::kN / 2];
  uint32_t p[8][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * j + e] = P[(row + 8 * (e >> 1)) * 128 + 8 * j + col + (e & 1)];
#pragma unroll
  for (int i = 0; i < T::kN / 2; ++i) o[i] = 0.f;
  pack_p<128>(s, p);
  mbar_wait(bar, 0);
  wgmma_fence();
  pv_gemm<D, 128>(o, p, sv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[(row + 8 * (e >> 1)) * D + 8 * j + col + (e & 1)] = o[4 * j + e];
}

// ---------------------------------------------------------------------------
// fp32: three TF32 passes on the tensor cores (mma.sync), a TMA ring
// ---------------------------------------------------------------------------

constexpr int kT32Block = 64;         // keys of a ring stage
constexpr int kT32Rows = 16;          // query rows of a consumer warp: one m16n8k8 A tile
constexpr int kT32MaxConsumers = 8;   // consumer warps of a CTA where their Q fits (4 at D 128)
constexpr int kT32MaxStages = 2;      // K and V stages of the ring at most
constexpr int kT32Passes = 3;         // 3: lo·hi + hi·lo + hi·hi; 1: hi·hi alone (one TF32 pass)
constexpr bool kT32SmallApart = true; // the small products in an accumulator of their own
constexpr bool kT32LoRound = false;   // lo rounded to TF32 (false: the MMA reads its TF32 bits)
constexpr int kF32BoxBytes = kT32Block * 128;  // one (64 keys x 32 fp32) swizzled TMA box
constexpr int kT32ProducerThreads = 128;       // warpgroup 0: one thread issues the loads

template <int D>
struct FwdTf32 {
  static constexpr int kBoxes = (D + 31) / 32;              // 32-column boxes of a block
  static constexpr int kTileBytes = kBoxes * kF32BoxBytes;  // one K or V block
  static constexpr int kKSteps = D / 8;                     // k8 steps of Q K^T, n8 tiles of O
  // a warp's Q: TF32 hi and lo A fragments, 8 floats a lane a k step
  static constexpr int kQWarpBytes = kKSteps * 32 * 32;
  // the alignment slack, the consumers' Q, two stages and their mbarriers
  static constexpr int kConsumers =
      1024 + kT32MaxConsumers * kQWarpBytes + 2 * (2 * kTileBytes + 32) <= kSmemLimit
          ? kT32MaxConsumers
          : kT32MaxConsumers / 2;
  static constexpr int kFit = (kSmemLimit - 1024 - kConsumers * kQWarpBytes) / (2 * kTileBytes + 32);
  static constexpr int kStages = kFit < kT32MaxStages ? kFit : kT32MaxStages;
  static constexpr int kBars = 4 * kStages;  // K and V full and empty
  static constexpr int kSmem = 1024 + 2 * kStages * kTileBytes + kConsumers * kQWarpBytes + 8 * kBars;
  static constexpr int kThreads = kT32ProducerThreads + 32 * kConsumers;
  // with two consumer warpgroups the producer's gives its registers to them
  // (setmaxnreg: 168 a thread at launch, 40 and 232 after; at 168 the
  // kernel spilled); with one, a thread has 255 from the start
  static constexpr bool kMoveRegs = kConsumers == 8;
  // P V in parts of at most 8 n8 tiles of O (the part's accumulators in
  // registers beside O)
  static constexpr int kPvParts = (kKSteps + 7) / 8;
  static constexpr int kPvTiles = kKSteps / kPvParts;
  static_assert(D % 8 == 0 && kPvTiles * kPvParts == kKSteps, "head dim");
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "shared memory");
};

// the TF32 value nearest x (ties away from zero), as fp32 bits with the low
// 13 mantissa bits zero: cvt.rna.tf32.f32's result for every finite x, by
// two integer operations (half a TF32 unit added to the magnitude's bits,
// then cut; ref.tf32_round's formula).  kT32CvtRna: by the cvt instruction
constexpr bool kT32CvtRna = false;
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  if constexpr (kT32CvtRna)
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  else
    r = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return r;
}

// x = hi + lo: hi = tf32(x) and lo = x - hi exactly, whose TF32 bits the
// MMA reads (its low 13 bits ignored: lo to 2^-10 of itself, the pair x to
// about 2^-21 of |x|; kT32LoRound rounds lo to TF32 first, 2^-22, at the
// cost of two more integer operations)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  const float rest = x - __uint_as_float(hi);
  lo = kT32Passes != 3 ? 0u : kT32LoRound ? tf32_rna(rest) : __float_as_uint(rest);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one k8 step of the three passes: the small products lo·hi and hi·lo into
// `small`, hi·hi into `big` (the same array where they are not kept apart)
__device__ __forceinline__ void mma_3pass(float (&big)[4], float (&small)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  if constexpr (kT32Passes == 3) {
    mma_tf32(small, al, bh0, bh1);
    mma_tf32(small, ah, bl0, bl1);
  }
  mma_tf32(big, ah, bh0, bh1);
}

// S (16 rows x 64 keys: register 4j+e holds row g + 8(e>>1), key 8j + 2t +
// (e&1), with g = lane/4, t = lane%4) = Q K^T for one warp.  Q's TF32 hi
// and lo A fragments of k step i come from the warp's slots (i, hi or lo,
// lane), 16 bytes each; K from its stage, key x D in 32-column boxes of
// 128-byte rows, 16-byte chunk c of row r at chunk c ^ (r % 8): the B
// fragment of keys 8j.. is K[8j + g][8i + t] and K[8j + g][8i + t + 4],
// chunks 2i % 8 and 2i % 8 + 1 of row g of the group, which puts the 32
// lanes on 32 banks
template <int D>
__device__ __forceinline__ void qk_tf32(float (&s)[32], const float4* qw, const float* k, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float big[8][4], small[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) big[j][e] = small[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const float4 h = qw[64 * i + lane], l = qw[64 * i + 32 + lane];
    const uint32_t ah[4] = {__float_as_uint(h.x), __float_as_uint(h.y), __float_as_uint(h.z),
                            __float_as_uint(h.w)};
    const uint32_t al[4] = {__float_as_uint(l.x), __float_as_uint(l.y), __float_as_uint(l.z),
                            __float_as_uint(l.w)};
    const float* kr = k + (i / 4) * (kF32BoxBytes / 4) + g * 32 + t;
    const int c0 = ((2 * i) % 8 ^ g) * 4, c1 = ((2 * i) % 8 + 1 ^ g) * 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(kr[j * 256 + c0], bh0, bl0);
      split_tf32(kr[j * 256 + c1], bh1, bl1);
      mma_3pass(big[j], kT32SmallApart ? small[j] : big[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = kT32SmallApart && kT32Passes == 3 ? big[j][e] + small[j][e] : big[j][e];
}

// O = O corr + P V for one warp and a block of 64 keys.  P (the softmax's
// s) is the A operand, split into TF32 hi and lo as it is used: S's
// columns 2t and 2t + 1 of n8 tile j serve as k = t and t + 4 of k step j,
// so V's B fragment is V[8j + 2t][8n + g] and V[8j + 2t + 1][8n + g] (row
// 2t or 2t + 1 of the group: chunk ^ 2t keeps the lanes on 32 banks).  The
// block's product goes into fresh accumulators (its small products apart)
// and is added to O in fp32, in parts of kPvTiles n8 tiles of O
// (registers).
template <int D>
__device__ __forceinline__ void pv_tf32(float (&o)[D / 2], const float (&p)[32],
                                        const float (&corr)[2], const float* v, int lane) {
  using T = FwdTf32<D>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int part = 0; part < T::kPvParts; ++part) {
    float big[T::kPvTiles][4], small[T::kPvTiles][4];
#pragma unroll
    for (int n = 0; n < T::kPvTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(p[4 * j], ah[0], al[0]);      // row g, key 8j + 2t: k = t
      split_tf32(p[4 * j + 2], ah[1], al[1]);  // row g + 8, the same key
      split_tf32(p[4 * j + 1], ah[2], al[2]);  // row g, key 8j + 2t + 1: k = t + 4
      split_tf32(p[4 * j + 3], ah[3], al[3]);
      const float* vr = v + (8 * j + 2 * t) * 32 + (g & 3);
#pragma unroll
      for (int n = 0; n < T::kPvTiles; ++n) {
        const int nt = part * T::kPvTiles + n;  // the n8 tile of O: columns 8 nt ..
        const int ch = 2 * (nt % 4) + (g >> 2);  // column 8 nt + g's chunk in its box
        const float* vb = vr + (nt / 4) * (kF32BoxBytes / 4);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vb[(ch ^ 2 * t) * 4], bh0, bl0);
        split_tf32(vb[32 + (ch ^ (2 * t + 1)) * 4], bh1, bl1);
        mma_3pass(big[n], kT32SmallApart ? small[n] : big[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < T::kPvTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = o[4 * (part * T::kPvTiles + n) + e];
        x = fmaf(x, corr[e >> 1], kT32SmallApart ? big[n][e] + small[n][e] : big[n][e]);
      }
  }
}

// The 64-key blocks that query rows r0 .. r0+15 read: the reference's KV
// blocks of their q block at the tile (bq, bk), cut at the last row's
// diagonal where every row sees a key (the keys past it would add exactly
// nothing); none for rows past Sq
__device__ __forceinline__ int tf32_warp_blocks(int r0, int Sq, int Skv, int bq, int bk,
                                                int causal) {
  if (r0 >= Sq) return 0;
  const int off = Skv - Sq;
  int end = (last_kv_block(causal, r0 / bq, bq, bk, Skv / bk, off) + 1) * bk;
  if (causal && r0 + off >= 0) end = min(end, r0 + kT32Rows + off);
  return end > 0 ? (end + kT32Block - 1) / kT32Block : 0;
}

// grid: one CTA per tile, CTA i taking tile i in fwd_tile's order (heavy
// causal q blocks first); tile (b*Hq + h, qt) holds query rows qt·16n ..
// of n consumer warps, consumer warp w rows 16w ..  The producer loads the
// tile's most blocks any warp reads; a warp past its own still waits on
// each block and releases it.
template <int D>
__global__ void __launch_bounds__(FwdTf32<D>::kThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tma_k,
                      const __grid_constant__ CUtensorMap tma_v, const float* __restrict__ Q,
                      float* __restrict__ O, int B, int Hq, int Hkv, int Sq, int Skv, int bq,
                      int bk, float c, int causal) {
  using T = FwdTf32<D>;
  constexpr int NC = T::kConsumers, S = T::kStages, TR = NC * kT32Rows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const float* sk = reinterpret_cast<const float*>(smem);  // [stages][boxes][64][32], swizzled
  const float* sv = sk + S * T::kTileBytes / 4;            // the same
  float4* sq = reinterpret_cast<float4*>(smem + 2 * S * T::kTileBytes);  // [warps][steps][2][32]
  const uint32_t bars = base + 2 * S * T::kTileBytes + NC * T::kQWarpBytes;
  auto k_full = [&](int s) { return bars + 8u * s; };
  auto v_full = [&](int s) { return bars + 8u * (S + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 * S + s); };
  auto v_empty = [&](int s) { return bars + 8u * (3 * S + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nqt = (Sq + TR - 1) / TR;
  int bh, qt;
  fwd_tile(blockIdx.x, B * Hq, nqt, bh, qt);
  int n = 0;  // the tile's most blocks any warp reads
  for (int w = 0; w < NC; ++w)
    n = max(n, tf32_warp_blocks(qt * TR + w * kT32Rows, Sq, Skv, bq, bk, causal));

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);    // the producer's arrive.expect_tx
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), NC);  // lane 0 of each consumer warp
      mbar_init(v_empty(s), NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // block j sits in stage j % S; its mbarriers' phase is (j / S) & 1
  if (threadIdx.x < kT32ProducerThreads) {
    if constexpr (T::kMoveRegs)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int b = bh / Hq, kvh = (bh % Hq) / (Hq / Hkv);
      const int kv_row = (b * Hkv + kvh) * Skv;
      for (int j = 0; j < n; ++j) {
        const int st = j % S, ph = (j / S) & 1;
        const uint32_t kdst = base + st * T::kTileBytes, vdst = base + (S + st) * T::kTileBytes;
        mbar_wait(k_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(k_full(st), T::kTileBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_2d(kdst + x * kF32BoxBytes, &tma_k, x * 32, kv_row + j * kT32Block, k_full(st));
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(v_full(st), T::kTileBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_2d(vdst + x * kF32BoxBytes, &tma_v, x * 32, kv_row + j * kT32Block, v_full(st));
      }
    }
    return;
  }

  if constexpr (T::kMoveRegs)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = warp - kT32ProducerThreads / 32, g = lane >> 2, tq = lane & 3;
  const int off = Skv - Sq;
  float4* qw = sq + cw * (T::kQWarpBytes / 16);
  const int r0 = qt * TR + cw * kT32Rows;
  const int nw = tf32_warp_blocks(r0, Sq, Skv, bq, bk, causal);
  const int key_lim[2] = {r0 + g + off, r0 + g + 8 + off};
  float o[D / 2], s[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  if (nw > 0) {  // Q's A fragments, split once into this lane's own slots
    const float* qg = Q + ((int64_t)bh * Sq + r0 + g) * D + tq;
#pragma unroll
    for (int x = 0; x < D / 8; ++x) {
      uint32_t h[4], lo[4];
      split_tf32(qg[8 * x], h[0], lo[0]);              // row g, d = 8x + t
      split_tf32(qg[8 * D + 8 * x], h[1], lo[1]);      // row g + 8
      split_tf32(qg[8 * x + 4], h[2], lo[2]);          // row g, d = 8x + t + 4
      split_tf32(qg[8 * D + 8 * x + 4], h[3], lo[3]);  // row g + 8
      qw[64 * x + lane] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                      __uint_as_float(h[2]), __uint_as_float(h[3]));
      qw[64 * x + 32 + lane] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                           __uint_as_float(lo[2]), __uint_as_float(lo[3]));
    }
  }
  for (int j = 0; j < n; ++j) {
    const int st = j % S, ph = (j / S) & 1;
    const bool work = j < nw;
    mbar_wait(k_full(st), ph);
    if (work) qk_tf32<D>(s, qw, sk + st * (T::kTileBytes / 4), lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(st));
    if (work) {  // the mask only where the block crosses a row's diagonal
      if (causal && j * kT32Block + kT32Block - 1 > r0 + off)
        softmax_block<true>(s, m, l, corr, c, j * kT32Block, key_lim);
      else
        softmax_block<false>(s, m, l, corr, c, j * kT32Block, key_lim);
    }
    mbar_wait(v_full(st), ph);
    if (work) pv_tf32<D>(o, s, corr, sv + st * (T::kTileBytes / 4), lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(st));
  }
  if (r0 < Sq) {  // o / max(l, 1e-30); a row that read no block writes zeros
    float* og = O + ((int64_t)bh * Sq + r0 + g) * D + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float denom = fmaxf(l[r], kMinDenom);
#pragma unroll
      for (int x = 0; x < D / 8; ++x)
        *reinterpret_cast<float2*>(og + r * 8 * D + 8 * x) =
            make_float2(o[4 * x + 2 * r] / denom, o[4 * x + 2 * r + 1] / denom);
    }
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
// decode on the CUDA cores (fp32 at every head dim; bf16 at D 32, 80 and 96): a ring
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
  static constexpr int kCols = (D + 31) / 32;   // columns of O a lane owns in P V
  // lane i owns columns kCols i .., or, where 32 does not divide D, columns
  // i + 32 j, those at or past D masked
  static constexpr bool kStrided = D % 32 != 0;
  static constexpr int kTileBytes = kCoreBlock * D * sizeof(T);  // one K or V block
  static constexpr int kFit = kCoreRingBytes / (2 * kTileBytes);
  // 3, 6 or 12 stages, so 3 or 6 consumer warps divide them
  static constexpr int kRing = kFit >= kCoreMaxStages ? kCoreMaxStages
                               : kFit >= 6           ? kFit / 6 * 6
                               : kFit >= 3           ? 3
                                                     : kFit;
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
  static_assert(D % 16 == 0 && kChunks >= 4, "head dim");
  // the column of O that slot j of lane `lane` holds (D or more: none)
  __device__ static int col(int lane, int j) { return kStrided ? lane + 32 * j : kCols * lane + j; }
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
      // O += P V: lane owns columns C::col(lane, j) of every head
      mbar_wait(v_full(st), ph);
      const T* vt = sv + st * kCoreBlock * D + C::col(lane, 0);
#pragma unroll 2
      for (int k4 = 0; k4 < kCoreBlock; k4 += 4) {
        float p4[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g) load_f32<4>(pw + g * kCoreBlock + k4, p4[g]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float vv[C::kCols];
          if constexpr (C::kStrided) {
#pragma unroll
            for (int j = 0; j < C::kCols; ++j)
              vv[j] = C::col(lane, j) < D ? to_float(vt[(k4 + e) * D + 32 * j]) : 0.f;
          } else {
            load_cols<C::kCols>(vt + (k4 + e) * D, vv);
          }
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
      for (int j = 0; j < C::kCols; ++j)
        if (!C::kStrided || C::col(lane, j) < D) mine[g * (D + 2) + C::col(lane, j)] = o[g][j];
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

template <int D>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                    int Sq, int Skv, int bq, int bk, float scale, int causal, cudaStream_t s) {
  using T = FwdTf32<D>;
  // TMA row coordinates are 32-bit
  if ((int64_t)B * Hkv * Skv > INT32_MAX) return (int)cudaErrorInvalidValue;
  // k and v as row-major (B*Hkv*Skv, D) fp32 matrices in (64 rows, 32 columns) boxes
  CUtensorMap mk, mv;
  int rc = encode_f32(&mk, k, B * Hkv * Skv, D, kT32Block);
  if (rc == 0) rc = encode_f32(&mv, v, B * Hkv * Skv, D, kT32Block);
  if (rc != 0) return rc;
  auto kern = flash_fwd_tf32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int rows = T::kConsumers * kT32Rows;  // query rows of a tile
  const int tiles = B * Hq * ((Sq + rows - 1) / rows);
  kern<<<tiles, T::kThreads, T::kSmem, s>>>(
      mk, mv, static_cast<const float*>(q), static_cast<float*>(o), B, Hq, Hkv, Sq, Skv, bq, bk,
      scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

// rbq, rbk: the reference's tile, whose KV blocks the rows that see no key
// average (no_key_end): multiples of BK, flash_fwd_launch checks
template <int D, int BK>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                     int Sq, int Skv, int rbq, int rbk, float scale, int causal, cudaStream_t s) {
  using T = FwdWgmma<D, BK>;
  // TMA row coordinates are 32-bit
  if ((int64_t)B * Hq * Sq > INT32_MAX || (int64_t)B * Hkv * Skv > INT32_MAX || Sq % BK ||
      Skv % BK)
    return (int)cudaErrorInvalidValue;
  // q, k and v as row-major (B*H*S, D) matrices in (kRows or BK rows, 64 columns) boxes
  CUtensorMap mq, mk, mv;
  int rc = encode_bf16(&mq, q, B * Hq * Sq, D, T::kRows);
  if (rc == 0) rc = encode_bf16(&mk, k, B * Hkv * Skv, D, BK);
  if (rc == 0) rc = encode_bf16(&mv, v, B * Hkv * Skv, D, BK);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kern = flash_fwd_wgmma_kernel<D, BK>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = B * Hq * ((Sq + T::kRows - 1) / T::kRows);
  const int slots = T::kCtasPerSm * sms;  // persistent: at most kCtasPerSm CTAs an SM
  const int grid = tiles < slots ? tiles : slots;
  kern<<<grid, T::kThreads, T::kSmem, s>>>(mq, mk, mv, static_cast<bf16*>(o), B, Hq, Hkv, Sq, Skv,
                                           rbq, rbk, scale * kLog2e, causal);
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

// the head dims of the repo's configs, which every route serves
constexpr bool head_dim(int D) { return D == 32 || D == 64 || D == 80 || D == 96 || D == 128; }

}  // namespace

extern "C" {

// The forward kernel for elem_bytes 2 (bf16) or 4 (fp32), head dim D and
// tile (bq, bk): kRouteWgmma for bf16 at (128, 128) and (64, 64),
// kRouteSplitTf32 for fp32 (both tiles), each at every head dim;
// kRouteNone for anything not instantiated.  (2 is no longer a route.)
enum { kRouteNone = 0, kRouteWgmma = 1, kRouteCudaCores = 3, kRouteTmaMma = 4, kRouteSplitTf32 = 5 };

int flash_fwd_route(int elem_bytes, int D, int bq, int bk) {
  const bool big = bq == 128 && bk == 128, small = bq == 64 && bk == 64;
  if ((!big && !small) || !head_dim(D)) return kRouteNone;
  if (elem_bytes == 2) return kRouteWgmma;
  return elem_bytes == 4 ? kRouteSplitTf32 : kRouteNone;
}

// launches the kernel flash_fwd_route names at the tile (bq, bk); the rows
// that see no key (causal, Skv < Sq) average the keys of the reference's
// KV blocks at the tile (rbq, rbk), which the caller asked for and which
// must be a multiple of (bq, bk) (the fp32 kernel's block rule;
// no_key_end).  A combination flash_fwd_route does not name, or such
// blocks, return cudaErrorInvalidValue without launching.
int flash_fwd_launch(int elem_bytes, const void* q, const void* k, const void* v, void* o, int B,
                     int Hq, int Hkv, int Sq, int Skv, int D, int bq, int bk, int rbq, int rbk,
                     float scale, int causal, void* stream) {
  if (bq < 1 || bk < 1 || rbq < 1 || rbk < 1 || rbq % bq || rbk % bk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WGMMA(HD)                                                                                 \
  return bk == 128 ? launch_fwd_wgmma<HD, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, rbq, rbk, scale, \
                                               causal, s)                                         \
                   : launch_fwd_wgmma<HD, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, rbq, rbk, scale,  \
                                              causal, s)
#define SPLIT(HD) return launch_fwd_tf32<HD>(q, k, v, o, B, Hq, Hkv, Sq, Skv, rbq, rbk, scale, causal, s)
  switch (flash_fwd_route(elem_bytes, D, bq, bk)) {
    case kRouteWgmma:
      if (D == 32) WGMMA(32);
      if (D == 64) WGMMA(64);
      if (D == 80) WGMMA(80);
      if (D == 96) WGMMA(96);
      WGMMA(128);
    case kRouteSplitTf32:
      if (D == 32) SPLIT(32);
      if (D == 64) SPLIT(64);
      if (D == 80) SPLIT(80);
      if (D == 96) SPLIT(96);
      SPLIT(128);
  }
#undef SPLIT
#undef WGMMA
  return (int)cudaErrorInvalidValue;
}

// the RS fragment probe: p fp32 (64, 128), v bf16 (128, D), o fp32 (64, D),
// D one of the head dims, all contiguous on the card
int flash_pv_probe_launch(const void* p, const void* v, void* o, int D, void* stream) {
  if (!head_dim(D)) return (int)cudaErrorInvalidValue;
  CUtensorMap mv;
  if (int rc = encode_bf16(&mv, v, 128, D, 128)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pp = static_cast<const float*>(p);
  auto* po = static_cast<float*>(o);
#define PROBE(HD)                                                         \
  if (D == HD) {                                                          \
    constexpr int smem = FwdWgmma<HD, 128>::kKvBytes + 1024 + 8;          \
    if (int err = set_smem(flash_pv_probe_kernel<HD>, smem)) return err;  \
    flash_pv_probe_kernel<HD><<<1, 128, smem, s>>>(mv, pp, po);           \
  }
  PROBE(32) PROBE(64) PROBE(80) PROBE(96) PROBE(128)
#undef PROBE
  return (int)cudaGetLastError();
}

// The decode kernel for elem_bytes 2 (bf16) or 4 (fp32) and head dim D:
// kRouteTmaMma for bf16 at D 64 and 128, kRouteCudaCores for bf16 at D 32,
// 80 and 96 and fp32 at every head dim, kRouteNone for anything not
// instantiated.
int flash_decode_route(int elem_bytes, int D) {
  if (!head_dim(D) || (elem_bytes != 2 && elem_bytes != 4)) return kRouteNone;
  if (elem_bytes == 2 && (D == 64 || D == 128)) return kRouteTmaMma;
  return kRouteCudaCores;
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
      if (elem_bytes == 2) {
        if (D == 32) DEC(bf16, 32);
        if (D == 80) DEC(bf16, 80);
        if (D == 96) DEC(bf16, 96);
        break;
      }
      if (D == 32) DEC(float, 32);
      if (D == 64) DEC(float, 64);
      if (D == 80) DEC(float, 80);
      if (D == 96) DEC(float, 96);
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
