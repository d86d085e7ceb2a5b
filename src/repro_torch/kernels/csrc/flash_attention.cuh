// Flash-attention forward for Hopper (sm_90a), 16-bit: GQA, causal or
// full, T in and out (T = __nv_bfloat16 or __half), f32 scores, softmax
// statistics and accumulator. The kernel and its host launcher are
// templates here; each translation unit instantiates its share, so that
// the build compiles them in parallel (one nvcc per source):
// flash_attention.cu bf16 at head dims up to 128 (beside the f32 kernel),
// flash_attention_f16.cu the same in f16, flash_attention_wide.cu both
// types at head dims 129-256.
//
// Replaces the TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py,
// launched by `flash_attention_pallas`). The TPU kernel walks a sequential
// grid axis over KV blocks and carries (m, l, acc) in VMEM scratch from one
// grid step to the next; here one thread block owns one (batch*q-head,
// q-tile) pair and loops over the KV tiles itself, with the statistics and
// the accumulator in registers.
//
// Bound on this card: at yi-6b prefill (B=1, Hq=32, Hkv=4, D=128) with
// S=1024 causal the work is 4*32*1024*1025/2*128 ~ 8.6 GFLOP, 8.7 us at
// 989 TFLOP/s (bf16 and f16 alike), against ~19 MB of q/k/v/o, 5.6 us at
// 3.35 TB/s: the tensor cores bound it, so the design is about keeping
// them fed:
//
// - Products are warpgroup `wgmma`, the only path to the full tensor-core
//   rate. Each consumer warpgroup owns 64 query rows: S = Q K^T is an SS
//   wgmma m64n{BK}k16 (Q and K both K-major in shared memory, D/16 steps);
//   O += P V is an RS wgmma m64n{D}k16 with P converted to T in the
//   registers the score accumulator came out in (for 16-bit types the
//   accumulator layout of one wgmma is the A-fragment layout of the next)
//   and V read MN-major through the descriptor's transpose bit. bf16 and
//   f16 take the same forms at the same rate; only the PTX type differs.
// - Loads are TMA, issued by one producer thread: the Q tile once, then a
//   ring of two K/V stages with a full and an empty mbarrier for each K and
//   each V, so K is refilled as soon as its scores are out and the next
//   tile lands while the current one is multiplied. The tensor maps are 3-D
//   [B*H, S, D], so rows past S within a head read as zeros and never the
//   next head's rows. Tiles are 128-byte swizzled, a 128-wide row stored
//   as two 64-column swizzle atoms.
// - Head dim 80 (stablelm-3b) is not a multiple of the 64-column atom. Its
//   tiles and accumulator are padded to 128 columns (two atoms) while the
//   tensor maps cover the real 80: the second box of each row reads columns
//   64-127, and TMA fills 80-127, out of bounds, with zeros (the barriers
//   count the whole box, fill included). Zero columns of Q and K add nothing
//   to Q K^T, which stops after 5 of the 8 k-steps (80 = 5 x 16); zero
//   columns of V keep the accumulator's columns 80-127 at zero, so they are
//   neither rescaled nor stored. P V does D=128's product work, 1.6x the
//   unpadded work: right and simple first.
// - Softmax overlaps the tensor cores twice over. Inside a warpgroup, step
//   i issues tile i's Q K^T and tile i-1's P V back to back and runs tile
//   i's softmax while P V is still running. With BQ = 128 two consumer
//   warpgroups share a block and take turns issuing (named barriers), so
//   one's softmax runs under the other's products; `setmaxnreg` moves
//   registers from the producer warpgroup (24) to them (240).
// - Masking runs only in the KV tiles that need it: those that cross the
//   diagonal (causal) and the ragged last tile. A zero-filled key row
//   scores 0, not -inf, so keys at or past S are masked explicitly to
//   -1e30 (the reference's mask value); KV tiles wholly above the diagonal
//   are never loaded; query rows past S are zero and never stored.
// - Under causal masking the q-tiles run heaviest first: the q-tile is the
//   slow grid axis, reversed, so the first wave holds every head's longest
//   tiles and the short ones fill the tail.
//
// - Any other head dim d (a multiple of 8 up to 256: TMA's 16-byte row
//   stride) runs a generic build of its padded width DP (64, 128, 192 or
//   256), the trick of D=80 with d passed at run time: TMA fills the
//   columns past d with zeros and a run-time `col < d` guards the store.
//   The accumulator's index stays compile-time (a run-time bound on a
//   register array would move it to local memory). Q K^T runs all DP/16
//   k-steps, those past ceil(d/16) over the zero fill: stopping early, by a
//   branch or by a predicated wgmma, made ptxas serialize the wgmma
//   pipeline (C7515) in all eight generic instantiations of width 64 and
//   128, and at d=96 the stopped kernel was slower on the H100, not faster.
// - Widths 192 and 256 (Gemma 7B's 256-wide heads, say) hold a 64 x DP f32
//   accumulator, 96 or 128 registers a thread, beside the scores (BK/2)
//   and P (BK/4): P V is an RS wgmma m64n192k16 or m64n256k16. They are
//   built where their shared memory, 2*DP*(BQ + 4*BK) + 1152 bytes, fits
//   one block's 232,448: (64, 64), (64, 128) and (128, 64) at 192, (64, 64)
//   and (128, 64) at 256. With BQ = 128 the two consumer warpgroups need
//   `setmaxnreg`'s 240 registers to hold them without a spill.
//
// Layout: q [B*Hq, S, D], k/v [B*Hkv, S, D], o [B*Hq, S, D], all contiguous.
// Block (h, .) reads KV row (h / Hq) * Hkv + (h % Hq) / (Hq / Hkv).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;
constexpr int kAtomBytes = 128;  // one swizzled row: 64 16-bit elements
constexpr int kMaxDevices = 64;

// D is a built head dim, or 0: any head dim d <= DP, passed at run time
template <int BQ, int BK, int D, int DP = (D + 63) / 64 * 64>
struct Cfg {
  static_assert(BQ == 64 || BQ == 128, "BQ is one or two warpgroups of 64 rows");
  static_assert(BK == 64 || BK == 128, "BK is the N of an m64nBKk16 wgmma");
  static_assert(D == 64 || D == 80 || D == 128 || D == 0, "D is a built head dim or 0");
  static_assert(DP == 64 || DP == 128 || DP == 192 || DP == 256,
                "DP is one to four 64-column atoms");
  static_assert(D == 0 || DP == (D + 63) / 64 * 64, "a built D is padded to whole atoms");
  static constexpr int kConsumers = BQ / 64;              // consumer warpgroups
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
  static constexpr int kDP = DP;                  // D padded to whole atoms
  static constexpr int kCols = kDP / 64;           // atoms per row
  // whole boxes, out-of-bounds fill included: what TMA completes per tile
  static constexpr int kQBytes = BQ * kDP * 2;
  static constexpr int kKVBytes = BK * kDP * 2;  // one K or one V tile
  static constexpr int kKOff = kQBytes;        // stage st: K, then V
  static constexpr int kBarOff = kQBytes + kStages * 2 * kKVBytes;
  // barriers at kBarOff: q_full and a full and an empty barrier for each
  // stage's K and V (8 B each, 128 B reserved), and 1024 B of slack to
  // align the tiles' base to the swizzle period
  static constexpr int kSmem = kBarOff + 128 + 1024;
};

// 2^x by the special-function unit, denormal results flushed to zero (they
// weigh nothing next to a row sum of at least 1); exp2f would add a range
// fix-up to every element
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Scores to the log2 domain, masked where MASK: element 4j+e of a thread's
// accumulator is (row0 + 8*(e/2), key k0 + 8j + 2t + e%2).
template <bool MASK, int BK>
__device__ __forceinline__ void scale_scores(float (&sc)[BK / 2], float scale_log2,
                                             int k0, int t, int row0, int s,
                                             int causal) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = sc[i] * scale_log2;
    if (MASK) {
      const int key = k0 + (i / 4) * 8 + 2 * t + (i & 1);
      const int row = row0 + ((i & 2) ? 8 : 0);
      if (key >= s || (causal && key > row)) x = kNegInf;
    }
    sc[i] = x;
  }
}

template <typename T, int BQ, int BK, int D, int DP>
__global__ void __launch_bounds__(Cfg<BQ, BK, D, DP>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           T* __restrict__ o, int hq, int hkv, int s, int d,
                           float scale_log2, int causal) {
  using C = Cfg<BQ, BK, D, DP>;
  // the head dim: the built one, or the run-time d of a generic build
  const int dd = D > 0 ? D : d;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  // barriers: q_full, then per stage full_k, full_v, empty_k, empty_v
  const uint32_t bar_q = base + C::kBarOff;
  auto bar = [&](int kind, int st) { return bar_q + 8u * (1 + kind * kStages + st); };
  auto k_s = [&](int st) { return base + C::kKOff + st * 2u * C::kKVBytes; };
  auto v_s = [&](int st) { return k_s(st) + C::kKVBytes; };
  constexpr int kFullK = 0, kFullV = 1, kEmptyK = 2, kEmptyV = 3;

  const int h = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int kvrow = (h / hq) * hkv + (h % hq) / (hq / hkv);
  const int nk = (s + BK - 1) / BK;
  const int n_tiles = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar(kFullK, st), 1);
      mbar_init(bar(kFullV, st), 1);
      mbar_init(bar(kEmptyK, st), 128 * C::kConsumers);
      mbar_init(bar(kEmptyV, st), 128 * C::kConsumers);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::kConsumers) {
    // ---------------------------------------------------------- producer
    if constexpr (C::kConsumers == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == C::kConsumers * 128) {
      mbar_arrive_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) {
        tma_load_3d(q_s + c * BQ * kAtomBytes, &tq, bar_q, c * 64, q0, h);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        // K, then V, each once the consumers released tile i - kStages' copy
        const uint32_t parity = ((i / kStages) - 1) & 1;
        if (i >= kStages) mbar_wait(bar(kEmptyK, st), parity);
        mbar_arrive_expect_tx(bar(kFullK, st), C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) {
          tma_load_3d(k_s(st) + c * BK * kAtomBytes, &tk, bar(kFullK, st), c * 64, i * BK,
                      kvrow);
        }
        if (i >= kStages) mbar_wait(bar(kEmptyV, st), parity);
        mbar_arrive_expect_tx(bar(kFullV, st), C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) {
          tma_load_3d(v_s(st) + c * BK * kAtomBytes, &tv, bar(kFullV, st), c * 64, i * BK,
                      kvrow);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::kConsumers == 2) setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int t = lane & 3;                                         // column pair
    const int row0 = q0 + wg * 64 + (tid / 32) * 16 + (lane >> 2);  // and row0 + 8
    const int wg_row_min = q0 + wg * 64;
    const uint32_t q_wg = q_s + wg * 64 * kAtomBytes;

    float acc[C::kDP / 2];  // columns D..kDP-1 stay zero (V's fill)
#pragma unroll
    for (int i = 0; i < C::kDP / 2; ++i) acc[i] = 0.f;
    uint32_t pf[BK / 16][4];           // P of the previous tile as T A fragments
    float m0 = kNegInf, m1 = kNegInf;  // running max (log2 domain) of row0, row0+8
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

    // S = Q K^T of tile i: D/16 k-steps (the zero fill past D adds nothing),
    // step kk 32 bytes into column atom kk/4
    auto issue_s = [&](int i, float (&sc)[BK / 2]) {
#pragma unroll
      for (int kk = 0; kk < (D > 0 ? D : DP) / 16; ++kk) {
        const uint32_t a = q_wg + (kk / 4) * BQ * kAtomBytes + (kk % 4) * 32;
        const uint32_t b = k_s(i % kStages) + (kk / 4) * BK * kAtomBytes + (kk % 4) * 32;
        wgmma_ss<T, BK, 0>(sc, smem_desc_sw128(a, 16, 1024), smem_desc_sw128(b, 16, 1024),
                        kk > 0);
      }
    };
    // O += P V of tile i: V is [BK keys][D], MN-major here; step kk starts 16
    // key rows (2048 B) further, the two column atoms lie BK rows apart
    auto issue_pv = [&](int i) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_rs<T, C::kDP, 1>(acc, pf[kk],
                              smem_desc_sw128(v_s(i % kStages) + kk * 16 * kAtomBytes,
                                              BK * kAtomBytes, 1024),
                              1);
      }
    };
    // tile i's scores (landed) -> probabilities in place; updates m and l
    // and returns the factors the accumulator must be rescaled by
    auto softmax = [&](int i, float (&sc)[BK / 2], float& c0, float& c1) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) fence_operand(sc[j]);
      mbar_arrive(bar(kEmptyK, i % kStages));  // this thread is done with K of tile i
      const int k0 = i * BK;
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
    };
    // once no P V is in flight: rescale the accumulator (its columns below
    // D; the rest are zero) and pack P to T, v's type (the reference casts
    // p to v's dtype before p.v)
    auto rescale_and_pack = [&](const float (&sc)[BK / 2], float c0, float c1) {
#pragma unroll
      for (int j = 0; j < (D > 0 ? D : DP) / 8; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }
      // key tiles 2kk and 2kk+1 of the accumulator form k-step kk of P V
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pf[kk][0] = pack2<T>(sc[8 * kk], sc[8 * kk + 1]);
        pf[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto fence_acc_and_p = [&]() {
#pragma unroll
      for (int j = 0; j < C::kDP / 2; ++j) fence_operand(acc[j]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_operand(pf[kk][e]);
      }
    };
    // Two consumer warpgroups take turns issuing their products (named
    // barriers 1 and 2), so one runs its softmax while the tensor cores
    // work on the other's; warpgroup 0 goes first. Each warpgroup takes
    // n_tiles + 1 turns and passes every turn on but warpgroup 1's last.
    auto take_turn = [&]() {
      if constexpr (C::kConsumers == 2) named_barrier_sync(1 + wg, 256);
    };
    auto pass_turn = [&](bool last) {
      if constexpr (C::kConsumers == 2) {
        if (wg == 0 || !last) named_barrier_arrive(2 - wg, 256);
      }
    };
    if (C::kConsumers == 2 && wg == 1) named_barrier_arrive(1, 256);
    mbar_wait(bar_q, 0);

    {  // tile 0: its scores alone
      float sc[BK / 2], c0, c1;
      mbar_wait(bar(kFullK, 0), 0);
      take_turn();
      wgmma_fence();
      issue_s(0, sc);
      wgmma_commit();
      pass_turn(false);
      wgmma_wait<0>();
      softmax(0, sc, c0, c1);
      rescale_and_pack(sc, c0, c1);
    }
    // Step i issues tile i's S = Q K^T and tile i-1's O += P V back to back,
    // then runs tile i's softmax while P V is still on the tensor cores.
    for (int i = 1; i < n_tiles; ++i) {
      float sc[BK / 2], c0, c1;
      mbar_wait(bar(kFullK, i % kStages), (i / kStages) & 1);
      mbar_wait(bar(kFullV, (i - 1) % kStages), ((i - 1) / kStages) & 1);
      take_turn();
      wgmma_fence();
      issue_s(i, sc);
      wgmma_commit();
      issue_pv(i - 1);
      wgmma_commit();
      pass_turn(false);
      wgmma_wait<1>();  // S of tile i has landed; P V may still run
      softmax(i, sc, c0, c1);
      wgmma_wait<0>();  // P V of tile i-1 is done: acc, P and V are free
      fence_acc_and_p();
      mbar_arrive(bar(kEmptyV, (i - 1) % kStages));
      rescale_and_pack(sc, c0, c1);
    }
    {  // the last tile's P V
      const int i = n_tiles - 1;
      mbar_wait(bar(kFullV, i % kStages), (i / kStages) & 1);
      take_turn();
      wgmma_fence();
      issue_pv(i);
      wgmma_commit();
      pass_turn(true);
      wgmma_wait<0>();
      fence_acc_and_p();
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f);
    const float d1 = fmaxf(l1, 1e-30f);
    // the real D columns only, at row stride D (a generic build: a
    // run-time guard, col < d; d is even, so col + 1 < d too)
    T* oh = o + (size_t)h * s * dd;
#pragma unroll
    for (int j = 0; j < (D > 0 ? D : DP) / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (D == 0 && col >= dd) continue;
      if (row0 < s) {
        *reinterpret_cast<uint32_t*>(oh + (size_t)row0 * dd + col) =
            pack2<T>(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      }
      if (row0 + 8 < s) {
        *reinterpret_cast<uint32_t*>(oh + (size_t)(row0 + 8) * dd + col) =
            pack2<T>(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
      }
    }
  }
}

// ------------------------------------------------------------------- host

// the dynamic shared-memory limit of `kern`, raised once per device
template <typename K>
cudaError_t raise_smem(K kern, int bytes, bool (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int BQ, int BK, int D, int DP = (D + 63) / 64 * 64>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
                   int hkv, int s, int d, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<BQ, BK, D, DP>;
  auto kern = flash_fwd_wgmma_kernel<T, BQ, BK, D, DP>;
  static bool raised[kMaxDevices] = {};
  cudaError_t err = raise_smem(kern, C::kSmem, raised);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!make_map<T>(&tq, q, b * hq, s, d, BQ) || !make_map<T>(&tk, k, b * hkv, s, d, BK) ||
      !make_map<T>(&tv, v, b * hkv, s, d, BK)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(b * hq, (s + BQ - 1) / BQ);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, static_cast<T*>(o), hq,
                                                hkv, s, d, scale * kLog2e, causal);
  return cudaGetLastError();
}

// 16-bit, head dims up to 128, one instantiation per built head dim
// (BQ, BK, D), in bf16 (flash_attention.cu) and in f16
// (flash_attention_f16.cu)
#define FLASH_BUILT(X) \
  X(64, 64, 64) X(64, 128, 64) X(128, 64, 64) X(128, 128, 64) \
  X(64, 64, 80) X(64, 128, 80) X(128, 64, 80) X(128, 128, 80) \
  X(64, 64, 128) X(64, 128, 128) X(128, 64, 128) X(128, 128, 128)

// 16-bit, any other head dim up to 128: one instantiation per padded width
// (BQ, BK, DP)
#define FLASH_ANY_D_BUILT(X) \
  X(64, 64, 64) X(64, 128, 64) X(128, 64, 64) X(128, 128, 64) \
  X(64, 64, 128) X(64, 128, 128) X(128, 64, 128) X(128, 128, 128)

// a head dim the narrow builds (and the f32 kernel) take: a multiple of 8
// (TMA's 16-byte row stride in 16 bits) from 8 to 128
inline bool head_dim_ok(int d) { return d >= 8 && d <= 128 && d % 8 == 0; }

inline bool built_d(int d) { return d == 64 || d == 80 || d == 128; }

inline int padded(int d) { return (d + 63) / 64 * 64; }

// Dynamic shared memory of the 16-bit kernel that runs head dim d (at most
// 128) at (block_q, block_k), in bytes, or -1 when none is built for them
// (the count does not depend on which 16-bit type).
inline int narrow_smem_bytes(int d, int block_q, int block_k) {
  if (!head_dim_ok(d)) return -1;
#define FLASH_SMEM(BQ_, BK_, D_) \
  if (d == D_ && block_q == BQ_ && block_k == BK_) return Cfg<BQ_, BK_, D_>::kSmem;
  FLASH_BUILT(FLASH_SMEM)
#undef FLASH_SMEM
#define FLASH_SMEM_ANY(BQ_, BK_, DP_)                                        \
  if (!built_d(d) && padded(d) == DP_ && block_q == BQ_ && block_k == BK_) \
    return Cfg<BQ_, BK_, 0, DP_>::kSmem;
  FLASH_ANY_D_BUILT(FLASH_SMEM_ANY)
#undef FLASH_SMEM_ANY
  return -1;
}

// q, o: [b, hq, s, d]; k, v: [b, hkv, s, d]; T, contiguous, 16-byte
// aligned. d a multiple of 8 from 8 to 128 (64, 80 and 128 have their own
// instantiations), block_q, block_k in {64, 128}; anything else returns
// cudaErrorInvalidValue without launching.
template <typename T>
int narrow_fwd(const void* q, const void* k, const void* v, void* o, int b, int hq,
               int hkv, int s, int d, int block_q, int block_k, float scale, int causal,
               void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || s <= 0 || hq % hkv != 0 || !head_dim_ok(d)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(BQ_, BK_, D_)                                              \
  if (d == D_ && block_q == BQ_ && block_k == BK_)                            \
    return launch<T, BQ_, BK_, D_>(q, k, v, o, b, hq, hkv, s, d, scale, causal, st);
  FLASH_BUILT(FLASH_CASE)
#undef FLASH_CASE
#define FLASH_CASE_ANY(BQ_, BK_, DP_)                                            \
  if (!built_d(d) && padded(d) == DP_ && block_q == BQ_ && block_k == BK_)     \
    return launch<T, BQ_, BK_, 0, DP_>(q, k, v, o, b, hq, hkv, s, d, scale, causal, st);
  FLASH_ANY_D_BUILT(FLASH_CASE_ANY)
#undef FLASH_CASE_ANY
  return cudaErrorInvalidValue;
}

}  // namespace
