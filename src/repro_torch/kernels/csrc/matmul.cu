// Blocked matrix product for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], bf16
// in and out, f32 accumulation, A and B row-major.
//
// Replaces the TPU kernel `_matmul_kernel` (src/repro/kernels/matmul.py,
// launched by `matmul_pallas`). The TPU kernel walks a (M/bm, N/bn, K/bk)
// grid with K as the sequential third axis and carries the f32 accumulator
// in VMEM scratch from one K step to the next, zeroed at k=0 and written once
// at the last k. Here one thread block owns one (bm, bn) output tile and runs
// the K loop itself, with the accumulator in registers; the tile is cast to
// bf16 and written once at the end. bm, bn, bk and the stage count are
// template parameters, so the accumulator arrays stay in registers; the
// built set is the `sm90` knob list of src/repro_torch/core/spaces.py
// (SM90_MATMUL_TILES), which the static tuner ranks.
//
// Per K step the block stages an A tile [bm, bk] and a B tile [bk, bn] in
// shared memory with cp.async (16 bytes a thread, rows padded by 16 bytes so
// that ldmatrix is free of bank conflicts), through two stages when
// `double_buffer` is set (the copy of step k+1 overlaps the products of step
// k) or one. Warps own min(bm/2, 32) x min(bn/2, 64) sub-tiles, so every
// block has at least 4 warps (2 x 2 for the smallest tiles, 16 for 128 x 256)
// and a thread holds at most 64 accumulator floats. A fragments come from
// ldmatrix.x4; B is row-major [k][n] in shared memory,
// and ldmatrix.x4.trans turns it into the column-major B fragment that
// mma.sync.m16n8k16.row.col expects (two 8-wide n tiles per load).
//
// Bound on this card: at a yi-6b projection (M=2048 tokens, N=K=4096) the
// work is 2*2048*4096*4096 = 68.7 GFLOP, 69.5 us at 989 TFLOP/s, against
// 67 MB of A, B and C, 20 us at 3.35 TB/s: it is bound by the tensor cores.
// This simple design reaches only part of that: mma.sync does not reach the
// wgmma rate, and there is no TMA, no warp specialisation and no persistent
// tile loop yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 padding per shared row (16 bytes)

template <int BM, int BN, int BK>
struct Tile {
  static constexpr int kWarpM = BM / 2 < 32 ? BM / 2 : 32;  // 16 or 32 rows
  static constexpr int kWarpN = BN / 2 < 64 ? BN / 2 : 64;  // 16, 32 or 64
  static constexpr int kWarpsN = BN / kWarpN;
  static constexpr int kThreads = 32 * (BM / kWarpM) * kWarpsN;
  static constexpr int kLdA = BK + kPad;
  static constexpr int kLdB = BN + kPad;
  static constexpr int kStageElems = BM * kLdA + BK * kLdB;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one K step's A tile [BM, BK] and B tile [BK, BN] into a shared stage
template <int BM, int BN, int BK>
__device__ __forceinline__ void load_stage(bf16* sa, const bf16* a,
                                           const bf16* b, int n, int k, int m0,
                                           int n0, int k0) {
  using T = Tile<BM, BN, BK>;
  bf16* sb = sa + BM * T::kLdA;
  constexpr int kRowA = BK / 8;  // 16-byte chunks per row
  constexpr int kRowB = BN / 8;
  constexpr int kChunksA = BM * kRowA;
  constexpr int kChunksB = BK * kRowB;
#pragma unroll
  for (int j = 0; j < (kChunksA + T::kThreads - 1) / T::kThreads; ++j) {
    const int i = threadIdx.x + j * T::kThreads;
    if (kChunksA % T::kThreads == 0 || i < kChunksA) {
      const int r = i / kRowA;
      const int c = (i % kRowA) * 8;
      cp_async16(sa + r * T::kLdA + c, a + (size_t)(m0 + r) * k + k0 + c);
    }
  }
#pragma unroll
  for (int j = 0; j < (kChunksB + T::kThreads - 1) / T::kThreads; ++j) {
    const int i = threadIdx.x + j * T::kThreads;
    if (kChunksB % T::kThreads == 0 || i < kChunksB) {
      const int r = i / kRowB;
      const int c = (i % kRowB) * 8;
      cp_async16(sb + r * T::kLdB + c, b + (size_t)(k0 + r) * n + n0 + c);
    }
  }
}

template <int BM, int BN, int BK, bool DB>
__global__ void __launch_bounds__(Tile<BM, BN, BK>::kThreads)
    matmul_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                       bf16* __restrict__ c, int n, int k) {
  using T = Tile<BM, BN, BK>;
  constexpr int MT = T::kWarpM / 16;  // 16-row mma tiles of a warp
  constexpr int NT = T::kWarpN / 8;   // 8-wide mma tiles of a warp (even)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / T::kWarpsN) * T::kWarpM;
  const int wn = (warp % T::kWarpsN) * T::kWarpN;

  float acc[MT][NT][4] = {};
  const int steps = k / BK;

  load_stage<BM, BN, BK>(smem, a, b, n, k, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < steps; ++kt) {
    const int s = DB ? (kt & 1) : 0;
    if constexpr (DB) {
      if (kt + 1 < steps) {  // prefetch step kt+1 into the other stage
        load_stage<BM, BN, BK>(smem + ((kt + 1) & 1) * T::kStageElems, a, b, n,
                               k, m0, n0, (kt + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (kt > 0) {
        load_stage<BM, BN, BK>(smem, a, b, n, k, m0, n0, kt * BK);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();  // step kt's tiles are in shared memory for every warp

    const bf16* sa = smem + s * T::kStageElems;
    const bf16* sb = sa + BM * T::kLdA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm_x4(af[mt], sa + (wm + mt * 16 + lane % 16) * T::kLdA + kk +
                            (lane / 16) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        // matrices: k rows 0-7 / 8-15 of n tile nt, then of n tile nt+1
        uint32_t bf[4];
        ldsm_x4_trans(bf, sb + (kk + lane % 16) * T::kLdB + wn + nt * 8 +
                              (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][nt], af[mt], bf[0], bf[1]);
          mma_16816(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const int g = lane >> 2;  // row within an 8-row half of an mma tile
  const int t = lane & 3;   // column pair within an 8-wide mma tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const size_t row = m0 + wm + mt * 16 + g;
      const int col = n0 + wn + nt * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(c + row * n + col) =
          __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(c + (row + 8) * n + col) =
          __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int BM, int BN, int BK, bool DB>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k,
                   cudaStream_t stream) {
  using T = Tile<BM, BN, BK>;
  constexpr size_t kSmem = (DB ? 2 : 1) * T::kStageElems * sizeof(bf16);
  auto kern = matmul_bf16_kernel<BM, BN, BK, DB>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n / BN, m / BM);
  kern<<<grid, T::kThreads, kSmem, stream>>>(static_cast<const bf16*>(a),
                                             static_cast<const bf16*>(b),
                                             static_cast<bf16*>(c), n, k);
  return cudaGetLastError();
}

}  // namespace

// a [m, k], b [k, n], c [m, n]: bf16, row-major, contiguous, 16-byte
// aligned. Built for bm in {32, 64, 128}, bn in {32, 64, 128, 256}, bk in
// {32, 64, 128} and one or two stages; the blocks must divide the shape.
// Anything else returns cudaErrorInvalidValue without launching.
extern "C" int matmul_bf16(const void* a, const void* b, void* c, int m, int n,
                           int k, int bm, int bn, int bk, int double_buffer,
                           void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      m % bm != 0 || n % bn != 0 || k % bk != 0 || m / bm > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MM_CASE(BM_, BN_, BK_)                                            \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                \
    return double_buffer ? launch<BM_, BN_, BK_, true>(a, b, c, m, n, k, st) \
                         : launch<BM_, BN_, BK_, false>(a, b, c, m, n, k, st);
#define MM_BK(BM_, BN_) MM_CASE(BM_, BN_, 32) MM_CASE(BM_, BN_, 64) MM_CASE(BM_, BN_, 128)
#define MM_BN(BM_) MM_BK(BM_, 32) MM_BK(BM_, 64) MM_BK(BM_, 128) MM_BK(BM_, 256)
  MM_BN(32) MM_BN(64) MM_BN(128)
#undef MM_BN
#undef MM_BK
#undef MM_CASE
  return cudaErrorInvalidValue;
}
