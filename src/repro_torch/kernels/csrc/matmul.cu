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
// The f32 kernel (`matmul_f32`, below) is SIMT: true f32
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
// - Ragged tiles as in the 16-bit kernel: a ceil(m / BM) x ceil(n / BN) grid,
//   ceil(k / BK) stages of K, TMA's zero fill past the edges, and no store
//   of a row >= m or a column >= n (n and k multiples of 4: 16-byte rows).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "matmul.cuh"

namespace {

// ------------------------------------------------------------- f32, SIMT

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
