// Blocked matrix product for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], bf16
// in and out, f32 accumulation, A and B row-major.
//
// Replaces the TPU kernel `_matmul_kernel` (src/repro/kernels/matmul.py,
// launched by `matmul_pallas`). The TPU kernel walks a (M/bm, N/bn, K/bk)
// grid with K as the sequential third axis and carries the f32 accumulator
// in VMEM scratch from one K step to the next, zeroed at k=0 and written once
// at the last k. Here the accumulator of a (bm, bn) output tile lives in the
// registers of the block that owns the tile, which runs the K loop itself
// and writes the tile once, as bf16, at the end. bm, bn, bk and the stage
// count are template parameters; the built set is the `sm90` knob list of
// src/repro_torch/core/spaces.py (SM90_MATMUL_TILES), which the static tuner
// ranks.
//
// Bound on this card: at a yi-6b projection (M=2048 tokens, N=K=4096) the
// work is 2*2048*4096*4096 = 68.7 GFLOP, 69.5 us at 989 TFLOP/s, against
// 67 MB of A, B and C, 20 us at 3.35 TB/s: the tensor cores bound it at
// every yi-6b shape, so the design is about keeping them fed:
//
// - Products are warpgroup `wgmma`, the only path to the full tensor-core
//   rate. Each of the bm/64 consumer warpgroups owns 64 rows x bn of the
//   tile and issues SS wgmma m64n{bn}k16: A K-major, B row-major [K][N],
//   i.e. MN-major, read through the descriptor's transpose bit.
// - Loads are TMA, issued by one thread of a producer warpgroup. A stage
//   holds bk/64 slots of 64 K-columns (one 128-byte swizzle atom wide),
//   each an A box [bm rows][64] and bn/64 B boxes [64 K-rows][64 columns]
//   with a full and an empty mbarrier of its own: the shared memory is a
//   ring of (stages * bk/64) slots, refilled slot by slot. The consumers
//   start on a slot as soon as it lands.
// - With two stages the consumers keep one slot's wgmma group in flight:
//   they issue slot i, wait until slot i-1's group is done and release
//   slot i-1 at once, so at bk=128 the producer has up to three slots in
//   flight while one is multiplied. (Releasing a whole stage at a time
//   leaves one stage in flight, and was slower at every two-stage bk=128
//   tile on the H100.) With one stage there is no overlap: the
//   consumers multiply the whole stage, wait for its groups and release
//   all its slots, and the producer then loads all of them at once.
// - Blocks are persistent: the grid is the SM count times the blocks that
//   fit on one SM (both queried once per device), and block b takes output
//   tiles b, b + grid, ... The tiles run M-fastest, so the tiles in flight
//   at one time share a few B column panels, which are re-read from L2
//   rather than HBM (the unembed's B is 524 MB; A is 16 MB). The producer
//   runs ahead into the next tile while the consumers write this one.
// - The epilogue goes straight from the accumulators to global memory as
//   bf16 pairs; no C tile is staged in shared memory.
// - With two consumer warpgroups `setmaxnreg` gives them 240 registers and
//   the producer 24 (168 at launch for 384 threads), so a 64 x 256 f32
//   accumulator (128 registers a thread) fits without a spill.
//
// Layout: a [m, k], b [k, n], c [m, n], bf16, row-major, contiguous, 16-byte
// aligned; n and k multiples of 8 (TMA's row stride is a multiple of 16
// bytes). Built for bm in {64, 128}, bn in {64, 128, 256}, bk in {64, 128}
// and one or two stages (24 instantiations).
//
// Ragged tiles: the tiles need not divide the shape. The grid covers each
// dimension with ceil(dim / tile) tiles and the last one is ragged. TMA
// fills a box's elements past the tensor's edge with zeros (a box wholly
// past it too, as the last N box of a ragged bn=256 tile may be), and still
// counts the box's full bytes on the barrier. Zero columns of A meet zero
// rows of B, so a ragged last K slice adds nothing to the sum; the K loop
// counts its slots to whole stages (ceil(k / BK) * BK/64), so a one-stage
// kernel always multiplies a whole stage and no wgmma sits in a branch. The
// epilogue stores no row >= m and no column >= n.
//
// The f32 kernel (`matmul_f32`, below the bf16 one) is SIMT: true f32
// products by FFMA. TF32 tensor-core products miss the reference's f32
// tolerance (atol 2e-4 sqrt(K), rtol 2e-4), and wgmma takes tf32 operands
// only K-major, which the row-major B is not. Its bound is the FP32 rate,
// 67 TFLOP/s: at 2048x4096x4096, 68.7 GFLOP take 1.03 ms against 134 MB of
// A, B and C, 40 us at 3.35 TB/s, so the products bound it at every shape
// the tuner ranks, and the design keeps the FFMA units fed:
//
// - One block of 8 warps per (bm, bn) output tile, M-fastest. Warp w owns
//   rows w*bm/8 .. of the tile and lane l the columns l, l+32, ..., so a
//   thread holds bm/8 x bn/32 accumulators (up to 16 x 8) in registers.
// - A and B tiles are TMA boxes (f32, unswizzled) staged in shared memory,
//   one or two stages of bk: with two, stage kb+1 lands while kb is
//   multiplied. Each k step reads one A element per row (one address for
//   the warp: a broadcast) and 32 consecutive B elements per column group
//   (one bank each), then issues bm/8 x bn/32 FFMA.
// - Shared memory is the sm90 model's count, stages x (bm + bn) x bk x 4;
//   built at the 21 (bm, bn, bk, stages) whose stages fit one block, which
//   are the sm90 configurations the cost model scores without overflow.
// - Ragged tiles as in the bf16 kernel: a ceil(m / BM) x ceil(n / BN) grid,
//   ceil(k / BK) stages of K, TMA's zero fill past the edges, and no store
//   of a row >= m or a column >= n (n and k multiples of 4: 16-byte rows).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kAtomBytes = 128;  // one swizzled row: 64 bf16
constexpr int kBox = 64;         // K-columns of one box (one atom wide)
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90

template <int BM, int BN, int BK, int S>
struct Cfg {
  static_assert(BM == 64 || BM == 128, "BM is one or two warpgroups of 64 rows");
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN is the N of an m64nBNk16 wgmma");
  static_assert(BK == 64 || BK == 128, "BK is a multiple of the 64-column atom");
  static_assert(S == 1 || S == 2, "one or two stages");
  static constexpr int kConsumers = BM / 64;               // consumer warpgroups
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
  static constexpr int kSlotsPerStage = BK / kBox;
  static constexpr int kSlots = S * kSlotsPerStage;        // the ring
  static constexpr int kABox = BM * kAtomBytes;            // A box [BM][64]
  static constexpr int kBAtom = kBox * kAtomBytes;         // B atom [64][64]
  static constexpr int kSlotBytes = kABox + (BN / 64) * kBAtom;
  static constexpr int kStaged = kSlots * kSlotBytes;      // S * (BM + BN) * BK * 2
  // barriers after the slots: a full and an empty barrier per slot (8 B
  // each, 128 B reserved); 1024 B of slack align the tiles' base to the
  // swizzle period
  static constexpr int kSmem = kStaged + 128 + 1024;
  static_assert(kStaged == S * (BM + BN) * BK * 2, "a stage is A and B, unpadded");
  static_assert(8 * 2 * kSlots <= 128, "barriers fit their reserve");
  static_assert(kSmem <= kMaxSmem, "fits one block's shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int BM, int BN, int BK, int S>
__global__ void __launch_bounds__(Cfg<BM, BN, BK, S>::kThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, bf16* __restrict__ c,
                        int m, int n, int k) {
  using C = Cfg<BM, BN, BK, S>;
  constexpr int R = C::kSlots;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // slot q: the A box at base + q * kSlotBytes, then the B boxes
  auto a_s = [&](int q) { return base + q * C::kSlotBytes; };
  auto b_s = [&](int q) { return a_s(q) + C::kABox; };
  auto full = [&](int q) { return base + C::kStaged + 8u * q; };
  auto empty = [&](int q) { return base + C::kStaged + 8u * (R + q); };

  const int tiles_m = (m + BM - 1) / BM;
  const int tiles = tiles_m * ((n + BN - 1) / BN);
  // slots per tile: whole stages, the last one's K columns past k zero-filled
  const int nb = (k + BK - 1) / BK * C::kSlotsPerStage;

  if (threadIdx.x == 0) {
    for (int q = 0; q < R; ++q) {
      mbar_init(full(q), 1);
      mbar_init(empty(q), 128 * C::kConsumers);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::kConsumers) {
    // ---------------------------------------------------------- producer
    if constexpr (C::kConsumers == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == C::kConsumers * 128) {
      int it = 0;  // slots filled by this block, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * BM;
        const int n0 = (tile / tiles_m) * BN;
        for (int kb = 0; kb < nb; ++kb, ++it) {
          const int q = it % R;
          // the consumers released this slot's previous fill
          if (it >= R) mbar_wait(empty(q), ((it / R) - 1) & 1);
          mbar_arrive_expect_tx(full(q), C::kSlotBytes);
          tma_load_3d(a_s(q), &ta, full(q), kb * kBox, m0, 0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            tma_load_3d(b_s(q) + j * C::kBAtom, &tb, full(q), n0 + j * 64, kb * kBox, 0);
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::kConsumers == 2) setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int wg_row = wg * 64 * kAtomBytes;  // this warpgroup's rows of an A box

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // slot fill `it`: wait until it landed, then 4 k16 products as one
    // group (A: 32 B further into the atom per k16; B: 16 K-rows, 2048 B,
    // further; its 64-column atoms lie kBAtom apart). `first` overwrites acc.
    auto issue = [&](int it, bool first) {
      const int q = it % R;
      mbar_wait(full(q), (it / R) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) {
        const uint64_t da = smem_desc_sw128(a_s(q) + wg_row + kk * 32, 16, 1024);
        const uint64_t db = smem_desc_sw128(b_s(q) + kk * 16 * kAtomBytes, C::kBAtom, 1024);
        wgmma_ss<BN, 1>(acc, da, db, (first && kk == 0) ? 0 : 1);
      }
      wgmma_commit();
    };
    auto release = [&](int it) { mbar_arrive(empty(it % R)); };

    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * BM;
      const int n0 = (tile / tiles_m) * BN;
      if constexpr (S == 2) {
        issue(it, true);
        for (int kb = 1; kb < nb; ++kb) {
          issue(it + kb, false);
          wgmma_wait<1>();  // slot kb-1's group is done
          release(it + kb - 1);
        }
        wgmma_wait<0>();
        release(it + nb - 1);
      } else {
        for (int kb = 0; kb < nb; kb += C::kSlotsPerStage) {
#pragma unroll
          for (int h = 0; h < C::kSlotsPerStage; ++h) issue(it + kb + h, kb + h == 0);
          wgmma_wait<0>();
#pragma unroll
          for (int h = 0; h < C::kSlotsPerStage; ++h) release(it + kb + h);
        }
      }
      it += nb;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

      // element 4j+e of acc is (row 16*warp + lane/4 + 8*(e/2), column
      // 8j + 2*(lane%4) + e%2) of this warpgroup's 64 x BN; a ragged tile
      // stores only rows < m and columns < n (n is even: a pair is whole)
      const int row = m0 + wg * 64 + (tid / 32) * 16 + (lane >> 2);
      const int col = n0 + 2 * (lane & 3);
      bf16* c0 = c + (size_t)row * n + col;
      bf16* c8 = c0 + 8 * (size_t)n;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (col + 8 * j < n) {
          if (row < m)
            *reinterpret_cast<uint32_t*>(c0 + 8 * j) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
          if (row + 8 < m)
            *reinterpret_cast<uint32_t*>(c8 + 8 * j) =
                pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- f32, SIMT

template <int BM, int BN, int BK, int S>
struct CfgF32 {
  static_assert(BM == 64 || BM == 128, "BM is 8 warps of 8 or 16 rows");
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN is 2, 4 or 8 columns a lane");
  static_assert(BK == 64 || BK == 128, "BK is a TMA box of at most 256");
  static_assert(S == 1 || S == 2, "one or two stages");
  static constexpr int kThreads = 256;
  static constexpr int kTM = BM / 8;   // rows a thread owns
  static constexpr int kTN = BN / 32;  // columns a thread owns
  static constexpr int kABytes = BM * BK * 4;
  static constexpr int kStageBytes = (BM + BN) * BK * 4;
  static constexpr int kStaged = S * kStageBytes;
  // a full barrier per stage (8 B each, 128 B reserved) after the tiles;
  // 128 B of slack align the tiles' base to TMA's 128 bytes
  static constexpr int kSmem = kStaged + 128 + 128;
  static_assert(kSmem <= kMaxSmem, "fits one block's shared memory");
};

template <int BM, int BN, int BK, int S>
__global__ void __launch_bounds__(256, 1)
    matmul_f32_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb, float* __restrict__ c,
                      int m, int n, int k) {
  using C = CfgF32<BM, BN, BK, S>;
  constexpr int TM = C::kTM, TN = C::kTN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  auto a_s = [&](int st) { return base + st * C::kStageBytes; };
  auto b_s = [&](int st) { return a_s(st) + C::kABytes; };
  auto full = [&](int st) { return base + C::kStaged + 8u * st; };

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nb = (k + BK - 1) / BK;
  const int tid = threadIdx.x;
  auto issue = [&](int kb) {
    const int st = kb % S;
    mbar_arrive_expect_tx(full(st), C::kStageBytes);
    tma_load_3d(a_s(st), &ta, full(st), kb * BK, m0, 0);
    tma_load_3d(b_s(st), &tb, full(st), n0, kb * BK, 0);
  };
  if (tid == 0) {
    for (int st = 0; st < S; ++st) mbar_init(full(st), 1);
    fence_mbarrier_init();
    for (int kb = 0; kb < S && kb < nb; ++kb) issue(kb);
  }
  __syncthreads();

  const int w = tid / 32, lane = tid % 32;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  for (int kb = 0; kb < nb; ++kb) {
    const int st = kb % S;
    mbar_wait(full(st), (kb / S) & 1);
    const float* as = reinterpret_cast<const float*>(base_ptr + st * C::kStageBytes);
    const float* bs = as + BM * BK;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[(w * TM + i) * BK + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[kk * BN + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && kb + S < nb) issue(kb + S);
  }

  const int row = m0 + w * TM, col = n0 + lane;
  float* c0 = c + (size_t)row * n + col;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (row + i < m && col + 32 * j < n) c0[(size_t)i * n + 32 * j] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------- host

template <int BM, int BN, int BK, int S>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k,
                   cudaStream_t stream) {
  using C = Cfg<BM, BN, BK, S>;
  auto kern = matmul_wgmma_kernel<BM, BN, BK, S>;
  // once per device: raise the dynamic shared-memory limit, then size the
  // persistent grid from the SM count and the blocks that fit on one SM
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, C::kThreads,
                                                        C::kSmem);
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  CUtensorMap ta, tb;
  // A as [1, m, k] in boxes [BM rows][64]; B as [1, k, n] in boxes [64][64]
  if (!make_map(&ta, a, 1, m, k, BM) || !make_map(&tb, b, 1, k, n, kBox)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int grid = tiles < resident[dev] ? tiles : resident[dev];
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(ta, tb, static_cast<bf16*>(c), m, n, k);
  return cudaGetLastError();
}

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
  // A as [1, m, k] in boxes [BM rows][BK]; B as [1, k, n] in boxes [BK][BN]
  if (!make_map_f32(&ta, a, 1, m, k, BM, BK) || !make_map_f32(&tb, b, 1, k, n, BK, BN)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(ta, tb, static_cast<float*>(c), m, n, k);
  return cudaGetLastError();
}

// every built (BM, BN, BK) tile, each with one and two stages
#define MM_BUILT(X)                                                            \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128) X(64, 256, 64)   \
  X(64, 256, 128) X(128, 64, 64) X(128, 64, 128) X(128, 128, 64)               \
  X(128, 128, 128) X(128, 256, 64) X(128, 256, 128)

// f32: every (BM, BN, BK, stages) whose stages fit one block's shared memory
#define MM_F32_BUILT(X)                                                             \
  X(64, 64, 64, 1) X(64, 64, 64, 2) X(64, 64, 128, 1) X(64, 64, 128, 2)             \
  X(64, 128, 64, 1) X(64, 128, 64, 2) X(64, 128, 128, 1) X(64, 128, 128, 2)         \
  X(64, 256, 64, 1) X(64, 256, 64, 2) X(64, 256, 128, 1) X(128, 64, 64, 1)          \
  X(128, 64, 64, 2) X(128, 64, 128, 1) X(128, 64, 128, 2) X(128, 128, 64, 1)        \
  X(128, 128, 64, 2) X(128, 128, 128, 1) X(128, 256, 64, 1) X(128, 256, 64, 2)      \
  X(128, 256, 128, 1)

}  // namespace

// Shared memory the (bm, bn, bk) instantiation with one (double_buffer = 0)
// or two stages holds for its A and B tiles, in bytes; its launch adds 128 B
// of barriers and 1024 B of alignment slack. -1 where none is built.
extern "C" int matmul_smem_bytes(int bm, int bn, int bk, int double_buffer) {
#define MM_SMEM(BM_, BN_, BK_)                           \
  if (bm == BM_ && bn == BN_ && bk == BK_)               \
    return double_buffer ? Cfg<BM_, BN_, BK_, 2>::kStaged \
                         : Cfg<BM_, BN_, BK_, 1>::kStaged;
  MM_BUILT(MM_SMEM)
#undef MM_SMEM
  return -1;
}

// a [m, k], b [k, n], c [m, n]: bf16, row-major, contiguous, 16-byte
// aligned, n and k multiples of 8 (TMA's 16-byte row stride). Built for bm
// in {64, 128}, bn in {64, 128, 256}, bk in {64, 128} and one or two
// stages; a tile that does not divide the shape is ragged. Anything else
// returns cudaErrorInvalidValue without launching.
extern "C" int matmul_bf16(const void* a, const void* b, void* c, int m, int n,
                           int k, int bm, int bn, int bk, int double_buffer,
                           void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MM_CASE(BM_, BN_, BK_)                                          \
  if (bm == BM_ && bn == BN_ && bk == BK_)                              \
    return double_buffer ? launch<BM_, BN_, BK_, 2>(a, b, c, m, n, k, st) \
                         : launch<BM_, BN_, BK_, 1>(a, b, c, m, n, k, st);
  MM_BUILT(MM_CASE)
#undef MM_CASE
  return cudaErrorInvalidValue;
}

// Shared memory the f32 (bm, bn, bk) instantiation with one (double_buffer =
// 0) or two stages holds for its A and B tiles, in bytes; its launch adds 128
// B of barriers and 128 B of alignment slack. -1 where none is built.
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
