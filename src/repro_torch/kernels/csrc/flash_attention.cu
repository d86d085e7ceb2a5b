// Flash-attention forward for Hopper (sm_90a), bf16 at head dims up to 128
// and f32: this library's entry points. The bf16 kernel is the 16-bit
// kernel of flash_attention.cuh (its design and bound are described
// there), instantiated for __nv_bfloat16; its f16 instantiations are in
// flash_attention_f16.cu, both types' head dims 129-256 in
// flash_attention_wide.cu and 257-512 in flash_attention_chunked.cu, each a
// library of its own so that the build compiles them in parallel.
//
// Replaces the TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py,
// launched by `flash_attention_pallas`).
//
// The f32 kernels (`flash_attention_fwd_f32`, below) run on the tensor
// cores in three TF32 passes at every width. Their bound: FFMA caps a SIMT
// kernel at the FP32 rate, 67 TFLOP/s (at yi-6b's heads with S=1024
// causal, 8.6 GFLOP take 128 us, against 38 MB of q/k/v/o, 11 us at 3.35
// TB/s); the tensor cores take tf32 at 495 TFLOP/s, and three passes of
// 8.6 GFLOP take 52 us there. One TF32 pass misses the reference's f32
// limit (atol 3e-5, rtol 3e-4); three do not: each operand splits as x =
// hi + lo (`split_tf32`, cvt.rna), and each product is accumulated in f32
// as hi.lo, lo.hi and hi.hi in that order, each part-product exact in f32
// and the dropped lo.lo about 2^-22 relative. The design keeps the tensor
// cores fed:
//
// - One block per (batch*q-head, q-tile), the 16-bit kernel's grid, GQA
//   row map, online softmax in the log2 domain, scale fold, mask, causal
//   tile skip and heaviest-first q-tile order. Each consumer warpgroup
//   owns 64 query rows; with BQ = 128 the two take turns issuing (named
//   barriers), so one's softmax runs under the other's products.
// - S = Q K^T: Q and K are both K-major (D contiguous), so it is an SS
//   wgmma m64n{BK}k8, three per k8 step. TMA lands Q and K in 128-byte-
//   swizzled boxes of 32 floats (one tf32 atom), the columns past d zero.
//   Q's hi and lo are split once per block (Q is reused by every key
//   tile), K's hi in place and its lo into a tile of its own.
// - O += P V: P is the register operand, the score accumulator after the
//   softmax split in registers, as the 16-bit kernel keeps P. A tf32 A
//   fragment holds columns t and t+4 where the accumulator holds 2t and
//   2t+1, so each k8 step's keys are taken in the order 0, 2, 4, 6, 1, 3,
//   5, 7: the fragment is the accumulator's registers as they are, and V^T
//   is written in the same key order. V is N-major, so it lands unswizzled
//   and the converter warps write V^T's hi and lo as K-major swizzled
//   tiles ([columns][32 keys] per 32 keys): BK*DP elements a tile against
//   6*BQ*BK*DP flops.
// - The producer warpgroup's warp 0 issues the TMA loads; its warps 1-3
//   (with BQ = 128 and a second warpgroup, 7 warps) split Q, then each K
//   tile and write each V^T tile in the order the consumers take them.
//   Each buffer has a full barrier (TMA), a ready barrier (split, after a
//   fence to the async proxy) and an empty one. The splits cost: a build
//   without them took 0.114 ms at yi-6b's heads, S=1024, against 0.185
//   (H100, benchmarks/flash_ab.py), about the share of shared-memory
//   traffic they add (192 of about 544 KB a tile at (64, 64), width 128).
//   With 7 converter warps instead of 3 the kernel took 0.98x the time
//   there and 0.91-0.92x at BQ = 128, so BQ = 64 keeps 3 and its 256
//   threads, whose consumers may take up to 255 registers with no
//   setmaxnreg.
//
// Up to 128 columns (`flash_fwd_f32_kernel`) every tile is whole, one
// buffer of each: Q hi and lo, K (hi) and its lo, V as it lands, V^T hi and
// lo: 4 * (2 * BQ * DP + 5 * BK * DP) bytes plus 128 of barriers and 1024 of
// alignment slack. That fits one block at (64, 64), (64, 128), (128, 64)
// and (128, 128) at width 64 and (64, 64) at 128. K of tile i+1 lands and
// is split while tile i's softmax and P V run, and V of tile i while tile
// i+1's Q K^T runs. With BK = 64 a warpgroup issues tile i's Q K^T and
// tile i-1's P V back to back and runs tile i's softmax under P V (P of
// tile i-1, 64 registers of hi and lo, stays live beside the scores of
// tile i); with BK = 128 P is 128 registers and the warpgroup runs Q K^T,
// softmax and P V in turn. With BQ = 128 `setmaxnreg` leaves the
// producer side 40 registers and gives a consumer thread 216 (512
// threads, 128 at launch).
//
// Past 128 columns (`flash_fwd_f32_wide_kernel`, widths 192 and 256, head
// dims 136-256) those tiles would take 344,064 B at (64, 64) and 192
// columns; one block may use 232,448. Only Q stays whole (its hi and lo,
// 98,304 B at 192, 131,072 at 256); K and V stream through one ring of
// 64-column chunks, each stage a chunk's hi and lo (64 keys x 64 columns,
// 16 KB each): 4 stages at 192 and 3 at 256, 230,528 B with Q, barriers and
// slack (4 * (2 * BQ * DP + stages * 2 * BK * 64) + 1152), built at (64, 64)
// only. Each key tile takes DP/64 K chunks, then DP/64 V chunks, in the
// ring's order:
// - S = Q K^T accumulates over the K chunks, 8 k8 steps of three SS
//   wgmma m64n64k8 each; a K chunk lands by TMA in the stage's hi half
//   (two swizzled boxes of 32 columns) and is split in place, its lo in
//   the other half.
// - The softmax, then O[:, 64c, 64c + 64) += P V_c for each chunk c, 8 k8
//   steps of three RS wgmma m64n64k8 into that 32-register slice of the
//   accumulator. A V chunk lands unswizzled in the stage's lo half
//   ([64 keys][64 columns]); the converters read all of it, write V^T's hi
//   into the hi half, meet at a named barrier and write V^T's lo over what
//   landed, so no landing tile takes room of its own.
// - The consumer issues chunk c+1 before it waits for chunk c's products,
//   and hands chunk c's stage back then; the producer and converters run
//   up to a ring ahead, across the softmax and from one tile to the next.
//   There is no overlap of P V with the next softmax: at these widths a
//   tile's products are 8-16x its softmax, and the accumulator (128
//   registers at 256), P's hi and lo (64) and the scores (32) would not
//   all fit a thread's 255.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------ f32: the consumers' softmax

constexpr int kF32Atom = 32;  // f32 columns of one 128-byte swizzle atom

// The online softmax of the key tile at k0, its scores a m64nBK
// accumulator (this thread's rows row0 and row0 + 8, columns 8j + 2t and
// 8j + 2t + 1): scaled to the log2 domain and masked (in a tile that
// reaches past S or, causal, past the warpgroup's first row), the running
// maxima m0, m1 and this thread's share of the row sums l0, l1 updated, the
// scores turned into probabilities in place. c0 and c1 are the factors the
// output's rows must be rescaled by.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], int k0, int wg_row_min,
                                               float scale_log2, int t, int row0, int s,
                                               int causal, float& m0, float& m1, float& l0,
                                               float& l1, float& c0, float& c1) {
  if (k0 + BK > s || (causal && k0 + BK - 1 > wg_row_min)) {
    scale_scores<true, BK>(sc, scale_log2, k0, t, row0, s, causal);
  } else {
    scale_scores<false, BK>(sc, scale_log2, k0, t, row0, s, causal);
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  // a row's 8-column tiles are spread over the 4 lanes of one quad
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  c0 = exp2_ftz(m0 - mx0);
  c1 = exp2_ftz(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = exp2_ftz(sc[4 * j] - mx0);
    sc[4 * j + 1] = exp2_ftz(sc[4 * j + 1] - mx0);
    sc[4 * j + 2] = exp2_ftz(sc[4 * j + 2] - mx1);
    sc[4 * j + 3] = exp2_ftz(sc[4 * j + 3] - mx1);
    ps0 += sc[4 * j] + sc[4 * j + 1];
    ps1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * c0 + ps0;
  l1 = l1 * c1 + ps1;
}

// Once no P V is in flight: the accumulator's rows rescaled by c0 and c1,
// and P split into tf32 A fragments of hi and lo. k-step kk of P V is key
// group kk of the scores, slot t its key 2t and slot t + 4 its key 2t + 1
// (V^T's key order).
template <int BK, int N>
__device__ __forceinline__ void rescale_and_split(float (&acc)[N], const float (&sc)[BK / 2],
                                                  float c0, float c1,
                                                  uint32_t (&phi)[BK / 8][4],
                                                  uint32_t (&plo)[BK / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= c0;
    acc[4 * j + 1] *= c0;
    acc[4 * j + 2] *= c1;
    acc[4 * j + 3] *= c1;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    split_tf32(sc[4 * kk], phi[kk][0], plo[kk][0]);      // row g, key 2t
    split_tf32(sc[4 * kk + 2], phi[kk][1], plo[kk][1]);  // row g + 8, key 2t
    split_tf32(sc[4 * kk + 1], phi[kk][2], plo[kk][2]);  // row g, key 2t + 1
    split_tf32(sc[4 * kk + 3], phi[kk][3], plo[kk][3]);  // row g + 8, key 2t + 1
  }
}

// The row sums gathered over each quad, then rows row0 and row0 + 8 of the
// output below S, its real d columns only (d is a multiple of 8: a pair is
// whole); columns past d of the accumulator are V's zero fill.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N], float l0, float l1,
                                           float* oh, int row0, int t, int s, int d) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= d) continue;
    if (row0 < s) {
      *reinterpret_cast<float2*>(oh + (size_t)row0 * d + col) =
          make_float2(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    }
    if (row0 + 8 < s) {
      *reinterpret_cast<float2*>(oh + (size_t)(row0 + 8) * d + col) =
          make_float2(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

// Every tile sits at a fixed address, so a k-step's descriptors are the
// same in every tile: made per k-step, ptxas hoisted them out of the tile
// loop (4 x DP/8 64-bit registers for Q K^T) and the (64, 64) build at
// width 128 spilled. An opaque copy of each base descriptor per use keeps
// them in the loop, one add per k-step (a descriptor's address field is
// the byte address >> 4, and no offset carries out of it).
__device__ __forceinline__ uint64_t opaque_desc(uint32_t addr) {
  uint64_t desc = smem_desc_sw128(addr, 16, 1024);
  asm volatile("" : "+l"(desc));
  return desc;
}

// ------------------------------------- f32 up to 128 columns, whole tiles

template <int BQ, int BK, int DP>
struct CfgTf32 {
  static_assert(BQ == 64 || BQ == 128, "BQ is one or two warpgroups of 64 rows");
  static_assert(BK == 64 || BK == 128, "BK is the N of an m64nBKk8 wgmma");
  static_assert(DP == 64 || DP == 128, "DP is the N of an m64nDPk8 wgmma");
  static constexpr int kConsumers = BQ / 64;
  // + the producer warpgroup (warp 0 issues TMA, 1-3 convert) and, with
  // two consumer warpgroups, a converter warpgroup: 3 or 7 converter warps
  static constexpr int kProducers = kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + kProducers);
  static constexpr int kConverters = 128 * kProducers - 32;
  // with 512 threads (128 registers each at launch) setmaxnreg leaves the
  // producer side 40 and gives a consumer thread what that frees
  static_assert(kConsumers == 1 || 256 * 40 + 256 * 216 <= 512 * 128,
                "setmaxnreg moves no more registers than the launch holds");
  static constexpr int kCols = DP / kF32Atom;              // atoms per Q or K row
  static constexpr int kQBytes = BQ * DP * 4;
  static constexpr int kKVBytes = BK * DP * 4;
  static constexpr int kVCols = DP;  // V lands in one box of the whole width
  // Q hi and lo, K (hi in place) and K lo, V as it lands, V^T hi and lo
  static constexpr int kQLo = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kKLo = kK + kKVBytes;
  static constexpr int kV = kKLo + kKVBytes;
  static constexpr int kVtHi = kV + kKVBytes;
  static constexpr int kVtLo = kVtHi + kKVBytes;
  static constexpr int kBarOff = kVtLo + kKVBytes;
  // nine barriers (8 B each, 128 B reserved) and 1024 B of slack to align
  // the tiles' base to the swizzle period
  static constexpr int kSmem = kBarOff + 128 + 1024;
  static_assert(kSmem == 4 * (2 * BQ * DP + 5 * BK * DP) + 1152, "the pickers' count");
  static_assert(kSmem <= 232448, "fits one block's shared memory");
  // P V of tile i-1 under tile i's softmax, where P's registers allow it
  static constexpr bool kOverlap = BK == 64;
};

template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(CfgTf32<BQ, BK, DP>::kThreads, 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                         int hq, int hkv, int s, int d, float scale_log2, int causal) {
  using C = CfgTf32<BQ, BK, DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  auto ptr = [&](int off) { return base_ptr + off; };
  const uint32_t q_s = base, q_lo = base + C::kQLo;
  const uint32_t k_s = base + C::kK, k_lo = base + C::kKLo;
  const uint32_t v_s = base + C::kV, vt_hi = base + C::kVtHi, vt_lo = base + C::kVtLo;
  const uint32_t bar = base + C::kBarOff;
  const uint32_t q_full = bar, q_ready = bar + 8, k_full = bar + 16, k_ready = bar + 24,
                 k_empty = bar + 32, v_full = bar + 40, v_free = bar + 48,
                 vt_ready = bar + 56, vt_empty = bar + 64;

  const int h = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int kvrow = (h / hq) * hkv + (h % hq) / (hq / hkv);
  const int nk = (s + BK - 1) / BK;
  const int n_tiles = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, C::kConverters);  // the converter warps split Q, K and V
    mbar_init(k_full, 1);
    mbar_init(k_ready, C::kConverters);
    mbar_init(k_empty, 128 * C::kConsumers);
    mbar_init(v_full, 1);
    mbar_init(v_free, C::kConverters);
    mbar_init(vt_ready, C::kConverters);
    mbar_init(vt_empty, 128 * C::kConsumers);
    fence_mbarrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg >= C::kConsumers) {
    // ------------------------------------------- producer and converters
    if constexpr (C::kConsumers == 2) setmaxnreg_dec<40>();
    const int pt = threadIdx.x - 128 * C::kConsumers;
    if (pt == 0) {
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) {
        tma_load_3d(q_s + c * BQ * kAtomBytes, &tq, q_full, c * kF32Atom, q0, h);
      }
      for (int i = 0; i < n_tiles; ++i) {
        // K once Q K^T of tile i-1 is done (its hi and lo are free), V once
        // tile i-1's V was written out as V^T
        if (i > 0) mbar_wait(k_empty, (i - 1) & 1);
        mbar_arrive_expect_tx(k_full, C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) {
          tma_load_3d(k_s + c * BK * kAtomBytes, &tk, k_full, c * kF32Atom, i * BK, kvrow);
        }
        if (i > 0) mbar_wait(v_free, (i - 1) & 1);
        mbar_arrive_expect_tx(v_full, C::kKVBytes);
        tma_load_3d(v_s, &tv, v_full, 0, i * BK, kvrow);
      }
    } else if (pt >= 32) {
      // the converter warps: Q once, then each K tile (hi in place, lo
      // beside it) and each V tile as V^T hi and lo, in the order the
      // consumers take them
      const int ct = pt - 32;
      constexpr int NC = C::kConverters;
      mbar_wait(q_full, 0);
      split_tf32_tile(reinterpret_cast<float4*>(ptr(0)),
                      reinterpret_cast<float4*>(ptr(C::kQLo)), C::kQBytes / 16, ct, NC);
      fence_proxy_async();
      mbar_arrive(q_ready);
      auto split_k = [&](int i) {
        mbar_wait(k_full, i & 1);
        split_tf32_tile(reinterpret_cast<float4*>(ptr(C::kK)),
                        reinterpret_cast<float4*>(ptr(C::kKLo)), C::kKVBytes / 16, ct, NC);
        fence_proxy_async();
        mbar_arrive(k_ready);
      };
      // V^T is K-major, one [DP][32] swizzled tile per 32 keys. Item (b,
      // ch, col): chunk ch (4 slots) of row col of tile b holds keys 32b +
      // 8(ch/2) + ch%2 + {0, 2, 4, 6}, the fragment's key order; lanes take
      // consecutive columns (one V row read without conflict, 8 chunks a
      // quarter-warp apart)
      const float* vs = reinterpret_cast<const float*>(ptr(C::kV));
      auto write_vt = [&](int i) {
        mbar_wait(v_full, i & 1);
        if (i > 0) mbar_wait(vt_empty, (i - 1) & 1);  // P V of tile i-1 is done
        for (int e = ct; e < (BK / kF32Atom) * 8 * DP; e += NC) {
          const int col = e % DP, ch = (e / DP) % 8, b = e / (8 * DP);
          const float* src = vs + (kF32Atom * b + 8 * (ch >> 1) + (ch & 1)) * DP + col;
          uint4 hi, lo;
          split_tf32(src[0], hi.x, lo.x);
          split_tf32(src[2 * DP], hi.y, lo.y);
          split_tf32(src[4 * DP], hi.z, lo.z);
          split_tf32(src[6 * DP], hi.w, lo.w);
          const int off = b * DP * kAtomBytes + col * kAtomBytes + ((ch ^ (col & 7)) << 4);
          *reinterpret_cast<uint4*>(ptr(C::kVtHi + off)) = hi;
          *reinterpret_cast<uint4*>(ptr(C::kVtLo + off)) = lo;
        }
        fence_proxy_async();
        mbar_arrive(v_free);
        mbar_arrive(vt_ready);
      };
      // with the overlap, step i needs K of tile i and V of tile i-1, and V
      // of tile i waits for P V of tile i-1: K runs a tile ahead of V
      split_k(0);
      for (int i = 0; i < n_tiles; ++i) {
        if (C::kOverlap && i + 1 < n_tiles) split_k(i + 1);
        write_vt(i);
        if (!C::kOverlap && i + 1 < n_tiles) split_k(i + 1);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::kConsumers == 2) setmaxnreg_inc<216>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int t = lane & 3;                                         // column pair
    const int row0 = q0 + wg * 64 + (tid / 32) * 16 + (lane >> 2);  // and row0 + 8
    const int wg_row_min = q0 + wg * 64;
    const uint32_t qh_wg = q_s + wg * 64 * kAtomBytes, ql_wg = q_lo + wg * 64 * kAtomBytes;

    float acc[DP / 2];  // columns past d stay zero (V's fill)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    uint32_t phi[BK / 8][4] = {}, plo[BK / 8][4] = {};  // P as tf32 A fragments
    float m0 = kNegInf, m1 = kNegInf;  // running max (log2 domain) of row0, row0+8
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

    // S = Q K^T: DP/8 k-steps (the zero fill past d adds nothing), step kk
    // 32 bytes into column atom kk/4; hi.lo, lo.hi, hi.hi
    auto issue_s = [&](float (&sc)[BK / 2]) {
      const uint64_t dqh = opaque_desc(qh_wg), dql = opaque_desc(ql_wg);
      const uint64_t dkh = opaque_desc(k_s), dkl = opaque_desc(k_lo);
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t oq = ((kk / 4) * BQ * kAtomBytes + (kk % 4) * 32) >> 4;
        const uint64_t ok = ((kk / 4) * BK * kAtomBytes + (kk % 4) * 32) >> 4;
        wgmma_tf32_ss<BK>(sc, dqh + oq, dkl + ok, kk > 0);
        wgmma_tf32_ss<BK>(sc, dql + oq, dkh + ok, 1);
        wgmma_tf32_ss<BK>(sc, dqh + oq, dkh + ok, 1);
      }
    };
    // O += P V: V^T is [DP][BK keys], K-major; step kk 32 bytes into key
    // atom kk/4
    auto issue_pv = [&]() {
      const uint64_t dvh = opaque_desc(vt_hi), dvl = opaque_desc(vt_lo);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t ov = ((kk / 4) * DP * kAtomBytes + (kk % 4) * 32) >> 4;
        wgmma_tf32_rs<DP>(acc, phi[kk], dvl + ov, 1);
        wgmma_tf32_rs<DP>(acc, plo[kk], dvh + ov, 1);
        wgmma_tf32_rs<DP>(acc, phi[kk], dvh + ov, 1);
      }
    };
    auto softmax = [&](int i, float (&sc)[BK / 2], float& c0, float& c1) {
      online_softmax<BK>(sc, i * BK, wg_row_min, scale_log2, t, row0, s, causal, m0, m1, l0,
                         l1, c0, c1);
    };
    auto rescale_and_split_p = [&](const float (&sc)[BK / 2], float c0, float c1) {
      rescale_and_split<BK>(acc, sc, c0, c1, phi, plo);
    };
    auto fence_scores = [&](float (&sc)[BK / 2]) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) fence_operand(sc[j]);
    };
    auto fence_acc_and_p = [&]() {
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) fence_operand(acc[j]);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(phi[kk][e]);
          fence_operand(plo[kk][e]);
        }
      }
    };
    // Two consumer warpgroups take turns issuing their products (named
    // barriers 1 and 2), warpgroup 0 first; each passes every turn on but
    // warpgroup 1's last.
    auto take_turn = [&]() {
      if constexpr (C::kConsumers == 2) named_barrier_sync(1 + wg, 256);
    };
    auto pass_turn = [&](bool last) {
      if constexpr (C::kConsumers == 2) {
        if (wg == 0 || !last) named_barrier_arrive(2 - wg, 256);
      }
    };
    if (C::kConsumers == 2 && wg == 1) named_barrier_arrive(1, 256);
    mbar_wait(q_ready, 0);

    if constexpr (C::kOverlap) {
      {  // tile 0: its scores alone (n_tiles + 1 turns)
        float sc[BK / 2], c0, c1;
        mbar_wait(k_ready, 0);
        take_turn();
        wgmma_fence();
        issue_s(sc);
        wgmma_commit();
        pass_turn(false);
        wgmma_wait<0>();
        fence_scores(sc);
        mbar_arrive(k_empty);
        softmax(0, sc, c0, c1);
        rescale_and_split_p(sc, c0, c1);
      }
      // step i issues tile i's S and tile i-1's P V back to back, then
      // runs tile i's softmax while P V is still on the tensor cores
      for (int i = 1; i < n_tiles; ++i) {
        float sc[BK / 2], c0, c1;
        mbar_wait(k_ready, i & 1);
        mbar_wait(vt_ready, (i - 1) & 1);
        take_turn();
        wgmma_fence();
        issue_s(sc);
        wgmma_commit();
        issue_pv();
        wgmma_commit();
        pass_turn(false);
        wgmma_wait<1>();  // S of tile i has landed; P V may still run
        fence_scores(sc);
        mbar_arrive(k_empty);
        softmax(i, sc, c0, c1);
        wgmma_wait<0>();  // P V of tile i-1 is done: acc, P and V^T are free
        fence_acc_and_p();
        mbar_arrive(vt_empty);
        rescale_and_split_p(sc, c0, c1);
      }
      {  // the last tile's P V
        mbar_wait(vt_ready, (n_tiles - 1) & 1);
        take_turn();
        wgmma_fence();
        issue_pv();
        wgmma_commit();
        pass_turn(true);
        wgmma_wait<0>();
        fence_acc_and_p();
      }
    } else {
      // Q K^T, softmax and P V in turn (2 n_tiles turns)
      for (int i = 0; i < n_tiles; ++i) {
        float sc[BK / 2], c0, c1;
        mbar_wait(k_ready, i & 1);
        take_turn();
        wgmma_fence();
        issue_s(sc);
        wgmma_commit();
        pass_turn(false);
        wgmma_wait<0>();
        fence_scores(sc);
        mbar_arrive(k_empty);
        softmax(i, sc, c0, c1);
        rescale_and_split_p(sc, c0, c1);
        mbar_wait(vt_ready, i & 1);
        take_turn();
        wgmma_fence();
        issue_pv();
        wgmma_commit();
        pass_turn(i == n_tiles - 1);
        wgmma_wait<0>();
        fence_acc_and_p();
        mbar_arrive(vt_empty);
      }
    }
    store_rows(acc, l0, l1, o + (size_t)h * s * d, row0, t, s, d);
  }
}

// --------------------------- f32 past 128 columns, K and V in 64-col chunks

template <int BQ, int BK, int DP>
struct CfgTf32Wide {
  static_assert(BQ == 64, "one consumer warpgroup: Q's hi and lo at BQ = 128 leave no stage");
  static_assert(BK == 64, "BK is the N of an m64n64k8 wgmma (P's hi and lo: 64 registers)");
  static_assert(DP == 192 || DP == 256, "DP is 3 or 4 chunks of 64 columns");
  static constexpr int kThreads = 256;  // the consumers, then the producer's warpgroup
  static constexpr int kConverters = 96;  // its warps 1-3 (warp 0 issues TMA)
  static constexpr int kChunk = 64;       // columns of a K or V chunk
  static constexpr int kChunks = DP / kChunk;
  static constexpr int kCols = DP / kF32Atom;  // atoms per Q row
  static constexpr int kVCols = kChunk;        // V lands one chunk per box
  static constexpr int kQBytes = BQ * DP * 4;
  static constexpr int kHalf = BK * kChunk * 4;  // a chunk's hi or lo: 16 KB
  static constexpr int kStage = 2 * kHalf;
  // as many stages as fit beside Q's hi and lo
  static constexpr int kStages = DP == 192 ? 4 : 3;
  static constexpr int kQLo = kQBytes;
  static constexpr int kRing = 2 * kQBytes;
  static constexpr int kBarOff = kRing + kStages * kStage;
  // q_full, q_ready and a full, ready and empty barrier per stage (8 B
  // each, 128 B reserved) and 1024 B of slack to align the tiles' base to
  // the swizzle period
  static_assert(8 * (2 + 3 * kStages) <= 128, "the barriers fit their 128 bytes");
  static constexpr int kSmem = kBarOff + 128 + 1024;
  static_assert(kSmem == 4 * (2 * BQ * DP + kStages * 2 * BK * 64) + 1152, "the pickers' count");
  static_assert(kSmem <= 232448, "fits one block's shared memory");
  static_assert(kSmem + kStage > 232448, "no further stage fits");
};

template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(CfgTf32Wide<BQ, BK, DP>::kThreads, 1)
    flash_fwd_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                              int hq, int hkv, int s, int d, float scale_log2, int causal) {
  using C = CfgTf32Wide<BQ, BK, DP>;
  constexpr int NS = C::kStages, NCH = C::kChunks;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base, q_lo = base + C::kQLo;
  // stage st: a chunk's hi at stage_hi(st), its lo C::kHalf further
  auto stage_hi = [&](int st) { return base + C::kRing + st * C::kStage; };
  const uint32_t bar = base + C::kBarOff;
  const uint32_t q_full = bar, q_ready = bar + 8;
  auto full = [&](int st) { return bar + 16 + 8 * st; };
  auto ready = [&](int st) { return bar + 16 + 8 * (NS + st); };
  auto empty = [&](int st) { return bar + 16 + 8 * (2 * NS + st); };

  const int h = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int kvrow = (h / hq) * hkv + (h % hq) / (hq / hkv);
  const int nk = (s + BK - 1) / BK;
  const int n_tiles = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, C::kConverters);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(full(st), 1);
      mbar_init(ready(st), C::kConverters);
      mbar_init(empty(st), 128);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  // The ring takes each key tile's NCH chunks of K, then its NCH chunks of
  // V: every thread walks it in that order, stage st on its pass `pass`
  // (the parity of its barriers' phase).
  int st = 0, pass = 0;
  auto advance = [&]() {
    if (++st == NS) {
      st = 0;
      pass ^= 1;
    }
  };
  if (threadIdx.x >= 128) {
    // ------------------------------------------- producer and converters
    const int pt = threadIdx.x - 128;
    if (pt == 0) {
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) {
        tma_load_3d(q_s + c * BQ * kAtomBytes, &tq, q_full, c * kF32Atom, q0, h);
      }
      bool wrapped = false;  // every stage was filled once
      for (int i = 0; i < n_tiles; ++i) {
        for (int c = 0; c < 2 * NCH; ++c) {
          // a stage once the consumers are done with its last chunk
          if (wrapped) mbar_wait(empty(st), pass ^ 1);
          mbar_arrive_expect_tx(full(st), C::kHalf);
          if (c < NCH) {  // K chunk c: two swizzled boxes of 32 columns
            tma_load_3d(stage_hi(st), &tk, full(st), c * C::kChunk, i * BK, kvrow);
            tma_load_3d(stage_hi(st) + BK * kAtomBytes, &tk, full(st),
                        c * C::kChunk + kF32Atom, i * BK, kvrow);
          } else {  // V chunk c - NCH, as it is, into the lo half
            tma_load_3d(stage_hi(st) + C::kHalf, &tv, full(st), (c - NCH) * C::kChunk,
                        i * BK, kvrow);
          }
          wrapped |= st == NS - 1;
          advance();
        }
      }
    } else if (pt >= 32) {
      // the converter warps: Q once, then each chunk in the ring's order
      const int ct = pt - 32;
      constexpr int NC = C::kConverters;
      mbar_wait(q_full, 0);
      split_tf32_tile(reinterpret_cast<float4*>(base_ptr),
                      reinterpret_cast<float4*>(base_ptr + C::kQLo), C::kQBytes / 16, ct, NC);
      fence_proxy_async();
      mbar_arrive(q_ready);
      // V^T is K-major, one [64 columns][32 keys] swizzled tile per 32 keys
      // in each half. Item (b, ch, col): chunk ch (4 slots) of row col of
      // tile b holds keys 32b + 8(ch/2) + ch%2 + {0, 2, 4, 6}, the
      // fragment's key order; lanes take consecutive columns (one V row
      // read without conflict, 8 chunks a quarter-warp apart)
      constexpr int kItems = (BK / kF32Atom) * 8 * C::kChunk;
      constexpr int kPer = (kItems + NC - 1) / NC;
      for (int i = 0; i < n_tiles; ++i) {
        for (int c = 0; c < 2 * NCH; ++c) {
          unsigned char* hi = base_ptr + C::kRing + st * C::kStage;
          unsigned char* lo = hi + C::kHalf;
          mbar_wait(full(st), pass);
          if (c < NCH) {
            split_tf32_tile(reinterpret_cast<float4*>(hi), reinterpret_cast<float4*>(lo),
                            C::kHalf / 16, ct, NC);
          } else {
            // V landed in the lo half: every converter reads its items and
            // writes their V^T hi, and once all have read, their V^T lo
            const float* vs = reinterpret_cast<const float*>(lo);
            uint4 keep[kPer];
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const int e = ct + j * NC;
              if (e < kItems) {
                const int col = e % C::kChunk, ch = (e / C::kChunk) % 8;
                const int b = e / (8 * C::kChunk);
                const float* src =
                    vs + (kF32Atom * b + 8 * (ch >> 1) + (ch & 1)) * C::kChunk + col;
                uint4 h4;
                split_tf32(src[0], h4.x, keep[j].x);
                split_tf32(src[2 * C::kChunk], h4.y, keep[j].y);
                split_tf32(src[4 * C::kChunk], h4.z, keep[j].z);
                split_tf32(src[6 * C::kChunk], h4.w, keep[j].w);
                const int off =
                    b * C::kChunk * kAtomBytes + col * kAtomBytes + ((ch ^ (col & 7)) << 4);
                *reinterpret_cast<uint4*>(hi + off) = h4;
              }
            }
            named_barrier_sync(3, NC);
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const int e = ct + j * NC;
              if (e < kItems) {
                const int col = e % C::kChunk, ch = (e / C::kChunk) % 8;
                const int b = e / (8 * C::kChunk);
                const int off =
                    b * C::kChunk * kAtomBytes + col * kAtomBytes + ((ch ^ (col & 7)) << 4);
                *reinterpret_cast<uint4*>(lo + off) = keep[j];
              }
            }
          }
          fence_proxy_async();
          mbar_arrive(ready(st));
          advance();
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int t = lane & 3;                           // column pair
    const int row0 = q0 + (tid / 32) * 16 + (lane >> 2);  // and row0 + 8

    float acc[DP / 2];  // columns past d stay zero (V's fill)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    uint32_t phi[BK / 8][4], plo[BK / 8][4];  // P as tf32 A fragments
    float m0 = kNegInf, m1 = kNegInf;  // running max (log2 domain) of row0, row0+8
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
    // keeps the compiler's reads and writes of the accumulator and P on
    // their side of the products that own them
    auto fence_acc_and_p = [&]() {
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) fence_operand(acc[j]);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(phi[kk][e]);
          fence_operand(plo[kk][e]);
        }
      }
    };

    mbar_wait(q_ready, 0);
    for (int i = 0; i < n_tiles; ++i) {
      // S = Q K^T over the K chunks: chunk c's k-step kk is Q's column atom
      // 2c + kk/4 and the chunk's atom kk/4, 32 bytes a step; hi.lo, lo.hi,
      // hi.hi. Chunk c+1 is issued before chunk c's stage is handed back.
      float sc[BK / 2], c0, c1;
      int prev = 0;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        mbar_wait(ready(st), pass);
        const uint64_t dqh = opaque_desc(q_s), dql = opaque_desc(q_lo);
        const uint64_t dkh = opaque_desc(stage_hi(st)), dkl = dkh + (C::kHalf >> 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t oq = ((2 * c + kk / 4) * BQ * kAtomBytes + (kk % 4) * 32) >> 4;
          const uint64_t ok = ((kk / 4) * BK * kAtomBytes + (kk % 4) * 32) >> 4;
          wgmma_tf32_ss<BK>(sc, dqh + oq, dkl + ok, c > 0 || kk > 0);
          wgmma_tf32_ss<BK>(sc, dql + oq, dkh + ok, 1);
          wgmma_tf32_ss<BK>(sc, dqh + oq, dkh + ok, 1);
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          mbar_arrive(empty(prev));
        }
        prev = st;
        advance();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) fence_operand(sc[j]);
      mbar_arrive(empty(prev));
      online_softmax<BK>(sc, i * BK, q0, scale_log2, t, row0, s, causal, m0, m1, l0, l1, c0,
                         c1);
      rescale_and_split<BK>(acc, sc, c0, c1, phi, plo);
      fence_acc_and_p();
      // O[:, 64c, 64c + 64) += P V_c, into the accumulator's 32-register
      // slice c: V^T chunk c is [64 columns][BK keys], K-major, step kk 32
      // bytes into key atom kk/4
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        mbar_wait(ready(st), pass);
        const uint64_t dvh = opaque_desc(stage_hi(st)), dvl = dvh + (C::kHalf >> 4);
        float(&oc)[C::kChunk / 2] = *reinterpret_cast<float(*)[C::kChunk / 2]>(
            &acc[c * C::kChunk / 2]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint64_t ov = ((kk / 4) * C::kChunk * kAtomBytes + (kk % 4) * 32) >> 4;
          wgmma_tf32_rs<C::kChunk>(oc, phi[kk], dvl + ov, 1);
          wgmma_tf32_rs<C::kChunk>(oc, plo[kk], dvh + ov, 1);
          wgmma_tf32_rs<C::kChunk>(oc, phi[kk], dvh + ov, 1);
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          mbar_arrive(empty(prev));
        }
        prev = st;
        advance();
      }
      wgmma_wait<0>();
      fence_acc_and_p();
      mbar_arrive(empty(prev));
    }
    store_rows(acc, l0, l1, o + (size_t)h * s * d, row0, t, s, d);
  }
}

// ------------------------------------------------------------------- host

// Q and K in swizzled boxes [rows][32 floats]; V in unswizzled boxes
// [BK][v_cols] (the whole width, or one 64-column chunk)
template <typename K>
cudaError_t launch_tf32(K kern, int smem, int threads, bool (&raised)[kMaxDevices], int bq,
                        int bk, int v_cols, const void* q, const void* k, const void* v,
                        void* o, int b, int hq, int hkv, int s, int d, float scale,
                        int causal, cudaStream_t stream) {
  cudaError_t err = raise_smem(kern, smem, raised);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!make_map_f32_sw128(&tq, q, b * hq, s, d, bq) ||
      !make_map_f32_sw128(&tk, k, b * hkv, s, d, bk) ||
      !make_map_f32(&tv, v, b * hkv, s, d, bk, v_cols)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(b * hq, (s + bq - 1) / bq);
  kern<<<grid, threads, smem, stream>>>(tq, tk, tv, static_cast<float*>(o), hq, hkv, s, d,
                                        scale * kLog2e, causal);
  return cudaGetLastError();
}

// the f32 kernel of a width: whole tiles up to 128 columns, 64-column
// chunks past it
template <int BQ, int BK, int DP>
constexpr int f32_smem() {
  if constexpr (DP <= 128) {
    return CfgTf32<BQ, BK, DP>::kSmem;
  } else {
    return CfgTf32Wide<BQ, BK, DP>::kSmem;
  }
}

template <int BQ, int BK, int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int hq,
                       int hkv, int s, int d, float scale, int causal, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  if constexpr (DP <= 128) {
    using C = CfgTf32<BQ, BK, DP>;
    return launch_tf32(flash_fwd_f32_kernel<BQ, BK, DP>, C::kSmem, C::kThreads, raised, BQ,
                       BK, C::kVCols, q, k, v, o, b, hq, hkv, s, d, scale, causal, stream);
  } else {
    using C = CfgTf32Wide<BQ, BK, DP>;
    return launch_tf32(flash_fwd_f32_wide_kernel<BQ, BK, DP>, C::kSmem, C::kThreads, raised,
                       BQ, BK, C::kVCols, q, k, v, o, b, hq, hkv, s, d, scale, causal,
                       stream);
  }
}

// f32, every (BQ, BK, DP) whose shared memory fits one block: whole tiles
// up to 128 columns, the chunked ring at 192 and 256
#define FLASH_F32_BUILT(X)                                                    \
  X(64, 64, 64) X(64, 128, 64) X(128, 64, 64) X(128, 128, 64) X(64, 64, 128) \
      X(64, 64, 192) X(64, 64, 256)

// a head dim the f32 kernels take: a multiple of 8 from 8 to 256
inline bool f32_head_dim_ok(int d) { return d >= 8 && d <= 256 && d % 8 == 0; }

}  // namespace

// Dynamic shared memory of the bf16 kernel that runs head dim d at
// (block_q, block_k), in bytes, or -1 when none is built for them.
extern "C" int flash_attention_smem_bytes(int d, int block_q, int block_k) {
  return narrow_smem_bytes(d, block_q, block_k);
}

// The same for the f32 kernels.
extern "C" int flash_attention_f32_smem_bytes(int d, int block_q, int block_k) {
  if (!f32_head_dim_ok(d)) return -1;
#define FLASH_SMEM_F32(BQ_, BK_, DP_)                       \
  if (padded(d) == DP_ && block_q == BQ_ && block_k == BK_) \
    return f32_smem<BQ_, BK_, DP_>();
  FLASH_F32_BUILT(FLASH_SMEM_F32)
#undef FLASH_SMEM_F32
  return -1;
}

// q, o: [b, hq, s, d]; k, v: [b, hkv, s, d]; bf16, contiguous, 16-byte
// aligned. d a multiple of 8 from 8 to 128 (64, 80 and 128 have their own
// instantiations), block_q, block_k in {64, 128}; anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* o, int b, int hq, int hkv, int s, int d,
                                        int block_q, int block_k, float scale,
                                        int causal, void* stream) {
  return narrow_fwd<bf16>(q, k, v, o, b, hq, hkv, s, d, block_q, block_k, scale, causal,
                          stream);
}

// The same in f32 (q, k, v, o float32; d a multiple of 8 from 8 to 256),
// for the (block_q, block_k) that FLASH_F32_BUILT holds at d's padded
// width.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       void* o, int b, int hq, int hkv, int s, int d,
                                       int block_q, int block_k, float scale,
                                       int causal, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || s <= 0 || hq % hkv != 0 || !f32_head_dim_ok(d)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE_F32(BQ_, BK_, DP_)                                         \
  if (padded(d) == DP_ && block_q == BQ_ && block_k == BK_)                   \
    return launch_f32<BQ_, BK_, DP_>(q, k, v, o, b, hq, hkv, s, d, scale, causal, st);
  FLASH_F32_BUILT(FLASH_CASE_F32)
#undef FLASH_CASE_F32
  return cudaErrorInvalidValue;
}
