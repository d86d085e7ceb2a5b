// Blocked matrix product for Hopper (sm_90a), bf16 and f32: this
// library's entry points. The bf16 kernel is the 16-bit kernel of
// matmul.cuh (its design, bound and ragged tiles are described there),
// instantiated for __nv_bfloat16; its f16 instantiations are in
// matmul_f16.cu, a library of its own so that the build compiles it in
// parallel.
//
// Replaces the TPU kernel `_matmul_kernel` (src/repro/kernels/matmul.py,
// launched by `matmul_pallas`).
//
// The f32 kernel (`matmul_f32`, below) runs on the tensor cores in three
// TF32 passes. Its bound: one FFMA per product caps a SIMT kernel at the
// FP32 rate, 67 TFLOP/s (at 2048x4096x4096, 68.7 GFLOP take 1.03 ms), while
// the tensor cores take tf32 at 495. One TF32 pass rounds each input to 10
// mantissa bits, about 2^-11 relative per product, which misses the
// reference's f32 limit (atol 2e-4 sqrt(K), rtol 2e-4). Three do not: each
// input splits as x = hi + lo, hi = tf32(x) and lo = tf32(x - hi)
// (`split_tf32`, cvt.rna), and A.B is accumulated in f32 as hi.lo, lo.hi
// and hi.hi in that order, each product of two tf32 values exact in f32
// and the dropped lo.lo about 2^-22 relative. Three passes at 495 TFLOP/s
// bound it at 0.42 ms at that shape (against 134 MB of A, B and C, 40 us at
// 3.35 TB/s), so the products bound it and the design keeps the tensor
// cores fed:
//
// - tf32 wgmma takes a shared-memory operand only K-major, which the
//   row-major B is not, while its register operand has no such
//   constraint. So the kernel computes C^T = B^T A^T: B^T is the register
//   operand (64 rows of N per warpgroup) and A, K-major as it is, the
//   shared-memory one, each wgmma m64n{bm}k8. B needs no transposing pass.
// - Loads are TMA, issued by one producer thread into a ring of
//   stages * bk/32 slots of 32 K-columns, each an A box [bm rows][32] and
//   bn/32 B boxes [32 K-rows][32 columns], all 128-byte swizzled (one
//   32-float atom wide), with a full, a ready and an empty mbarrier. No
//   __syncthreads runs per slot.
// - Three converter warps (the producer warpgroup's others) split each
//   landed A box in shared memory: hi in place, lo into a ring of two
//   [bm][32] slices, then fence the writes to the async proxy and arrive
//   on the slot's ready barrier. Both consumer warpgroups read the same
//   converted box.
// - Consumer warpgroup w owns bn/64/consumers 64-column slices of the
//   output's N: per k8 step each thread loads its B^T fragment (two 8-byte
//   loads per slice), splits it in registers and issues hi.lo, lo.hi and
//   hi.hi per slice as one wgmma group. One group stays in flight: the
//   fragments are double-buffered and the slot is released once its last
//   group is done. A thread's rows g and g+8 of the fragment are made the
//   adjacent columns 2i, 2i+1 of N (the epilogue stores them so), and the
//   column pairs of a warp are spread over the swizzled chunks so that the
//   8-byte loads meet no bank conflict.
// - With two consumer warpgroups `setmaxnreg` gives them 232 registers and
//   the producer warpgroup 40 (168 at launch for 384 threads): a thread
//   holds up to 2 x 64 accumulators and two buffers of fragments.
// - Shared memory is the sm90 model's count for the stages, stages x (bm +
//   bn) x bk x 4, plus the lo ring (2 x bm x 128 B), 256 B of barriers and
//   1024 B of alignment slack; built at the 21 (bm, bn, bk, stages) whose
//   stages fit one block, the sm90 configurations the cost model scores
//   without overflow.
// - The tensor cores' f32 accumulation is not round-to-nearest: its error
//   grows with the number of wgmma summed into one accumulator, not with
//   its square root. Summing all of K there, the max error against an f64
//   oracle at 1024 x 1024 x K was 0.35 of the reference's limit at K =
//   4096, 1.27 at 16384 and 4.9 at 65536, and 0.92 at yi-6b's 2048 x 4096
//   x 11008 (H100). So every 32 slots (1024 K-columns) the accumulator is
//   added to C in f32, rounded to nearest, and restarted from zero: at
//   most 0.09 of the limit at every K measured, up to 65536, for 7% of
//   the time at 2048 x 4096 x 4096 (the wgmma pipeline drains at each
//   flush; 8 rows' loads of C are in flight at once).
// - Ragged tiles as in the 16-bit kernel: a ceil(m / BM) x ceil(n / BN)
//   grid, ceil(k / 32) slots of K, TMA's zero fill past the edges (zeros
//   split into zeros), and no store of a row >= m or a column >= n (n and
//   k multiples of 4: 16-byte rows).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "matmul.cuh"

namespace {

// ------------------------------------------------------ f32, three-pass TF32

constexpr int kSlotK = 32;        // K-columns of a slot: one 128-byte atom of f32
constexpr int kConverters = 96;   // the producer warpgroup's warps 1-3
// slots whose products the tensor cores sum in one accumulator before it
// is added to C in f32 (see the design notes above); a build may set
// another count (benchmarks/flash_ab.py --define, to measure the choice)
#ifndef MM_F32_FLUSH_SLOTS
#define MM_F32_FLUSH_SLOTS 32
#endif
constexpr int kFlushSlots = MM_F32_FLUSH_SLOTS;

template <int BM, int BN, int BK, int S>
struct CfgF32 {
  static_assert(BM == 64 || BM == 128, "BM is the N of an m64nBMk8 wgmma");
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN is one to four 64-column slices");
  static_assert(BK == 64 || BK == 128, "BK is whole 32-column slots");
  static_assert(S == 1 || S == 2, "one or two stages");
  static constexpr int kConsumers = BN == 64 ? 1 : 2;      // consumer warpgroups
  static constexpr int kSlices = BN / 64 / kConsumers;      // 64-column slices of each
  static constexpr int kThreads = 128 * (kConsumers + 1);   // + the producer's
  static constexpr int kSlots = S * BK / kSlotK;            // the ring
  static constexpr int kABox = BM * kAtomBytes;             // A box [BM][32]
  static constexpr int kBBox = kSlotK * kAtomBytes;         // B box [32][32]
  static constexpr int kSlotBytes = kABox + (BN / 32) * kBBox;
  static constexpr int kStaged = kSlots * kSlotBytes;
  static constexpr int kLoOff = kStaged;                    // the lo ring: two A slices
  static constexpr int kBarOff = kLoOff + 2 * kABox;
  // a full, a ready and an empty barrier per slot (8 B each, 256 B
  // reserved); 1024 B of slack align the tiles' base to the swizzle period
  static constexpr int kSmem = kBarOff + 256 + 1024;
  static_assert(kStaged == S * (BM + BN) * BK * 4, "a stage is A and B, unpadded");
  static_assert(8 * 3 * kSlots <= 256, "barriers fit their reserve");
  static_assert(kSmem <= kMaxSmem, "fits one block's shared memory");
};

template <int BM, int BN, int BK, int S>
__global__ void __launch_bounds__(CfgF32<BM, BN, BK, S>::kThreads, 1)
    matmul_f32_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb, float* __restrict__ c,
                      int m, int n, int k) {
  using C = CfgF32<BM, BN, BK, S>;
  constexpr int R = C::kSlots, SL = C::kSlices;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  // slot q: the A box at base + q * kSlotBytes, then the B boxes; fill f's
  // lo in ring slice f % 2
  auto a_s = [&](int q) { return base + q * C::kSlotBytes; };
  auto b_s = [&](int q) { return a_s(q) + C::kABox; };
  auto lo_s = [&](int f) { return base + C::kLoOff + (f & 1) * C::kABox; };
  auto full = [&](int q) { return base + C::kBarOff + 8u * q; };
  auto ready = [&](int q) { return full(q) + 8u * R; };
  auto empty = [&](int q) { return full(q) + 16u * R; };
  auto ptr = [&](uint32_t a) { return base_ptr + (a - base); };

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nb = (k + kSlotK - 1) / kSlotK;  // slots; columns past k are zero fill

  if (threadIdx.x == 0) {
    for (int q = 0; q < R; ++q) {
      mbar_init(full(q), 1);
      mbar_init(ready(q), kConverters);
      mbar_init(empty(q), 128 * C::kConsumers);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::kConsumers) {
    // ------------------------------------------- producer and converters
    if constexpr (C::kConsumers == 2) setmaxnreg_dec<40>();
    const int pt = threadIdx.x % 128;
    if (pt == 0) {
      for (int f = 0; f < nb; ++f) {
        const int q = f % R;
        // the consumers released this slot's previous fill
        if (f >= R) mbar_wait(empty(q), ((f / R) - 1) & 1);
        mbar_arrive_expect_tx(full(q), C::kSlotBytes);
        tma_load_3d(a_s(q), &ta, full(q), f * kSlotK, m0, 0);
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
          tma_load_3d(b_s(q) + j * C::kBBox, &tb, full(q), n0 + 32 * j, f * kSlotK, 0);
        }
      }
    } else if (pt >= 32) {
      for (int f = 0; f < nb; ++f) {
        const int q = f % R;
        mbar_wait(full(q), (f / R) & 1);
        // ring slice f % 2 held fill f - 2, which the consumers released
        if (f >= 2) mbar_wait(empty((f - 2) % R), ((f - 2) / R) & 1);
        split_tf32_tile(reinterpret_cast<float4*>(ptr(a_s(q))),
                        reinterpret_cast<float4*>(ptr(lo_s(f))), C::kABox / 16, pt - 32,
                        kConverters);
        fence_proxy_async();  // the split, before the consumers' wgmma reads it
        mbar_arrive(ready(q));
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::kConsumers == 2) setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    // Rows g and g+8 of warp w's 16 fragment rows are the columns 2i and
    // 2i+1 of N in the warp's half of a 32-column B box (box w / 2 of the
    // slice): pair i at chunk `chunk` (16 B), half g % 2. A warp's lanes
    // of one k-row meet chunks {c, c+1} ^ t and {c+4, c+5} ^ t: 8 chunks
    // for each 16 lanes, one 8-byte load per bank.
    const int chunk = 2 * (w & 1) + 4 * ((g >> 1) & 1) + (g >> 2);
    // k-rows t (a0, a1) and t + 4 (a2, a3) of a k8 step, which lie 8 rows,
    // 1024 B, apart per step and keep their swizzle phase
    const int off0 = t * kAtomBytes + ((chunk ^ t) << 4) + ((g & 1) << 3);
    const int off1 = (t + 4) * kAtomBytes + ((chunk ^ (t + 4)) << 4) + ((g & 1) << 3);

    float acc[SL][BM / 2];
    auto fence_acc = [&]() {
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) fence_operand(acc[sl][i]);
      }
    };
    // The zeros are in place before the first wgmma reads them: without
    // the fence ptxas saw their moves inside the wgmma pipeline and
    // serialized every wgmma (C7515), in all 21 instantiations.
    auto zero_acc = [&]() {
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc[sl][i] = 0.f;
      }
      fence_acc();
    };
    // Element 4j+e of acc[sl] is (fragment row g + 8*(e/2), column 8j +
    // 2t + e%2) of C^T: rows g, g+8 are N columns col, col + 1, the column
    // is M's row. A ragged tile stores only rows < m and columns < n (n is
    // a multiple of 4: a pair is whole). With `add` the accumulator is
    // added, in f32, to what C holds: 8 rows' pairs are loaded before any
    // is stored, so 16 loads are in flight and not one at a time.
    auto store_c = [&](bool add) {
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
        const int col = n0 + 64 * (wg * SL + sl) + 32 * (w >> 1) + 4 * chunk + 2 * (g & 1);
        if (col >= n) continue;
        float2* c0 = reinterpret_cast<float2*>(c + (size_t)(m0 + 2 * t) * n + col);
#pragma unroll
        for (int j0 = 0; j0 < BM / 8; j0 += 8) {
          float2 was[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool in = m0 + 8 * (j0 + j) + 2 * t + e < m;
              was[j][e] = add && in ? c0[(size_t)(8 * (j0 + j) + e) * n / 2]
                                    : make_float2(0.f, 0.f);
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (m0 + 8 * (j0 + j) + 2 * t + e >= m) continue;
              c0[(size_t)(8 * (j0 + j) + e) * n / 2] =
                  make_float2(acc[sl][4 * (j0 + j) + e] + was[j][e].x,
                              acc[sl][4 * (j0 + j) + 2 + e] + was[j][e].y);
            }
          }
        }
      }
    };
    zero_acc();
    // fragments of two k8 steps: [step % 2][slice][hi, lo][register]
    uint32_t fr[2][SL][2][4] = {};
    for (int f = 0; f < nb; ++f) {
      const int q = f % R;
      mbar_wait(ready(q), (f / R) & 1);
      mbar_wait(full(q), (f / R) & 1);  // B's bytes, for this thread's loads
#pragma unroll
      for (int kk = 0; kk < kSlotK / 8; ++kk) {
        uint32_t(&fb)[SL][2][4] = fr[kk & 1];
#pragma unroll
        for (int sl = 0; sl < SL; ++sl) {
          const unsigned char* box =
              ptr(b_s(q)) + (2 * (wg * SL + sl) + (w >> 1)) * C::kBBox + kk * 1024;
          const float2 x0 = *reinterpret_cast<const float2*>(box + off0);
          const float2 x1 = *reinterpret_cast<const float2*>(box + off1);
          split_tf32(x0.x, fb[sl][0][0], fb[sl][1][0]);
          split_tf32(x0.y, fb[sl][0][1], fb[sl][1][1]);
          split_tf32(x1.x, fb[sl][0][2], fb[sl][1][2]);
          split_tf32(x1.y, fb[sl][0][3], fb[sl][1][3]);
        }
        const uint64_t dhi = smem_desc_sw128(a_s(q) + kk * 32, 16, 1024);
        const uint64_t dlo = smem_desc_sw128(lo_s(f) + kk * 32, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int sl = 0; sl < SL; ++sl) wgmma_tf32_rs<BM>(acc[sl], fb[sl][0], dlo, 1);
#pragma unroll
        for (int sl = 0; sl < SL; ++sl) wgmma_tf32_rs<BM>(acc[sl], fb[sl][1], dhi, 1);
#pragma unroll
        for (int sl = 0; sl < SL; ++sl) wgmma_tf32_rs<BM>(acc[sl], fb[sl][0], dhi, 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done: its fragments are free
#pragma unroll
        for (int sl = 0; sl < SL; ++sl) {
#pragma unroll
          for (int e = 0; e < 8; ++e) fence_operand(fr[(kk + 1) & 1][sl][e / 4][e % 4]);
        }
        // that group was the previous slot's last: release it
        if (kk == 0 && f > 0) mbar_arrive(empty((f - 1) % R));
      }
      // every kFlushSlots slots the partial sum goes to C and the tensor
      // cores start a new one
      if ((f + 1) % kFlushSlots == 0 && f + 1 < nb) {
        wgmma_wait<0>();
        fence_acc();
        store_c(f + 1 > kFlushSlots);
        zero_acc();
      }
    }
    wgmma_wait<0>();
    fence_acc();
    store_c(nb > kFlushSlots);
  }
}

// ------------------------------------------------------------------- host

template <int BM, int BN, int BK, int S>
cudaError_t launch_f32(const void* a, const void* b, void* c, int m, int n, int k,
                       cudaStream_t stream) {
  using C = CfgF32<BM, BN, BK, S>;
  auto kern = matmul_f32_kernel<BM, BN, BK, S>;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  CUtensorMap ta, tb;
  // A as [1, m, k] in boxes [BM rows][32]; B as [1, k, n] in boxes [32][32]
  if (!make_map_f32_sw128(&ta, a, 1, m, k, BM) || !make_map_f32_sw128(&tb, b, 1, k, n, kSlotK)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(ta, tb, static_cast<float*>(c), m, n, k);
  return cudaGetLastError();
}

// f32: every (BM, BN, BK, stages) whose stages fit one block's shared memory
#define MM_F32_BUILT(X)                                                             \
  X(64, 64, 64, 1) X(64, 64, 64, 2) X(64, 64, 128, 1) X(64, 64, 128, 2)             \
  X(64, 128, 64, 1) X(64, 128, 64, 2) X(64, 128, 128, 1) X(64, 128, 128, 2)         \
  X(64, 256, 64, 1) X(64, 256, 64, 2) X(64, 256, 128, 1) X(128, 64, 64, 1)          \
  X(128, 64, 64, 2) X(128, 64, 128, 1) X(128, 64, 128, 2) X(128, 128, 64, 1)        \
  X(128, 128, 64, 2) X(128, 128, 128, 1) X(128, 256, 64, 1) X(128, 256, 64, 2)      \
  X(128, 256, 128, 1)

}  // namespace

// Shared memory the bf16 (bm, bn, bk) instantiation with one (double_buffer
// = 0) or two stages holds for its A and B tiles, in bytes; its launch adds
// 128 B of barriers and 1024 B of alignment slack. -1 where none is built.
extern "C" int matmul_smem_bytes(int bm, int bn, int bk, int double_buffer) {
  return mm16_smem_bytes(bm, bn, bk, double_buffer);
}

// a [m, k], b [k, n], c [m, n]: bf16, row-major, contiguous, 16-byte
// aligned, n and k multiples of 8 (TMA's 16-byte row stride). Built for bm
// in {64, 128}, bn in {64, 128, 256}, bk in {64, 128} and one or two
// stages; a tile that does not divide the shape is ragged. Anything else
// returns cudaErrorInvalidValue without launching.
extern "C" int matmul_bf16(const void* a, const void* b, void* c, int m, int n,
                           int k, int bm, int bn, int bk, int double_buffer,
                           void* stream) {
  return mm16<__nv_bfloat16>(a, b, c, m, n, k, bm, bn, bk, double_buffer, stream);
}

// Shared memory the f32 (bm, bn, bk) instantiation with one (double_buffer =
// 0) or two stages holds for its A and B tiles, in bytes; its launch adds the
// lo ring (2 x bm x 128 B), 256 B of barriers and 1024 B of alignment slack.
// -1 where none is built.
extern "C" int matmul_f32_smem_bytes(int bm, int bn, int bk, int double_buffer) {
  const int stages = double_buffer ? 2 : 1;
#define MM_F32_SMEM(BM_, BN_, BK_, S_) \
  if (bm == BM_ && bn == BN_ && bk == BK_ && stages == S_) return CfgF32<BM_, BN_, BK_, S_>::kStaged;
  MM_F32_BUILT(MM_F32_SMEM)
#undef MM_F32_SMEM
  return -1;
}

// a [m, k], b [k, n], c [m, n]: f32, row-major, contiguous, 16-byte aligned,
// n and k multiples of 4 (TMA's 16-byte row stride); the blocks are in
// MM_F32_BUILT, and a tile that does not divide the shape is ragged.
// Anything else returns cudaErrorInvalidValue without launching.
extern "C" int matmul_f32(const void* a, const void* b, void* c, int m, int n, int k,
                          int bm, int bn, int bk, int double_buffer, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bn <= 0 || n % 4 != 0 || k % 4 != 0 ||
      (n + bn - 1) / bn > 65535) {
    return cudaErrorInvalidValue;
  }
  const int stages = double_buffer ? 2 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MM_F32_CASE(BM_, BN_, BK_, S_)                                  \
  if (bm == BM_ && bn == BN_ && bk == BK_ && stages == S_)              \
    return launch_f32<BM_, BN_, BK_, S_>(a, b, c, m, n, k, st);
  MM_F32_BUILT(MM_F32_CASE)
#undef MM_F32_CASE
  return cudaErrorInvalidValue;
}
