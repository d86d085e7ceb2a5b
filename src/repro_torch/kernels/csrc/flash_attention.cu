// Flash-attention forward for Hopper (sm_90a): GQA, causal or full, bf16 in
// and out, f32 scores, softmax statistics and accumulator.
//
// Replaces the TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py,
// launched by `flash_attention_pallas`). The TPU kernel walks a sequential
// grid axis over KV blocks and carries (m, l, acc) in VMEM scratch from one
// grid step to the next; here one thread block owns one (batch*q-head,
// q-tile) pair and loops over the KV tiles itself, with the statistics and
// the accumulator in registers.
//
// Layout: q [B*Hq, S, D], k/v [B*Hkv, S, D], o [B*Hq, S, D], all contiguous.
// Block h reads KV row (h / Hq) * Hkv + (h % Hq) / (Hq / Hkv).
//
// Each warp owns 16 query rows and issues mma.sync.m16n8k16 (bf16 x bf16 ->
// f32): S = Q K^T with the Q fragments held in registers for the whole
// loop, then P V with P cast to bf16 straight from the score registers, as
// the TPU kernel casts p to v's dtype before its second product. The q, k and
// v tiles sit in shared memory with rows padded by 16 bytes. Tails: rows of
// a tile at or past S are zero-filled on load, keys at or past S are masked
// to -1e30, and output rows at or past S are never written, so any S >= 1
// runs with any block size. Causal: keys are masked by absolute position and
// KV tiles wholly above the diagonal are never loaded.
//
// Bound on this card: at yi-6b prefill (B=1, Hq=32, Hkv=4, D=128) with
// S=1024 causal the work is 4*32*1024*1025/2*128 ~ 8.6 GFLOP, 8.7 us at
// 989 TFLOP/s, against ~19 MB of q/k/v/o, 5.6 us at 3.35 TB/s: it is bound by
// the tensor cores. This simple design does nothing about that yet: loads
// are synchronous (no cp.async/TMA pipeline), mma.sync reaches a fraction of
// the wgmma rate, and V fragments are assembled from 16-bit shared loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kPad = 8;            // bf16 padding per shared row (16 bytes)

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two consecutive bf16 in shared memory; the lower column in the low half
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of a [S, D] matrix into shared memory with row
// stride D + kPad, 16 bytes a thread; rows at or past s are zero-filled
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int s) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(BQ * 2)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int hq,
                     int hkv, int s, float scale, int causal) {
  constexpr int NT = BQ * 2;  // BQ / 16 warps
  constexpr int LD = D + kPad;
  constexpr int NKT = BK / 8;  // 8-wide key tiles of a score block
  constexpr int NDT = D / 8;   // 8-wide column tiles of the output
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int KK = BK / 16;  // k-steps of P V

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * LD;
  bf16* vs = ks + BK * LD;

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvrow = (h / hq) * hkv + (h % hq) / (hq / hkv);
  const bf16* qh = q + (size_t)h * s * D;
  const bf16* kh = k + (size_t)kvrow * s * D;
  const bf16* vh = v + (size_t)kvrow * s * D;

  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // column pair within an 8-wide tile
  const int r0 = (threadIdx.x / 32) * 16;
  const int qpos0 = q0 + r0 + g;  // this thread's two query rows
  const int qpos1 = qpos0 + 8;

  load_tile<BQ, D, NT>(qs, qh, q0, s);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const bf16* p = qs + (r0 + g) * LD + kd * 16 + t * 2;
    qf[kd][0] = ld_pair(p);
    qf[kd][1] = ld_pair(p + 8 * LD);
    qf[kd][2] = ld_pair(p + 8);
    qf[kd][3] = ld_pair(p + 8 * LD + 8);
  }

  float acc[NDT][4];
#pragma unroll
  for (int nd = 0; nd < NDT; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows qpos0, qpos1
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  const int nk = (s + BK - 1) / BK;
  const int last = causal ? min(nk - 1, (q0 + BQ - 1) / BK) : nk - 1;

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BK, D, NT>(ks, kh, k0, s);
    load_tile<BK, D, NT>(vs, vh, k0, s);
    __syncthreads();

    float sc[NKT][4];
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const bf16* p = ks + (nt * 8 + g) * LD + kd * 16 + t * 2;
        mma_16816(sc[nt], qf[kd][0], qf[kd][1], qf[kd][2], qf[kd][3],
                  ld_pair(p), ld_pair(p + 8));
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + nt * 8 + t * 2 + j;
        float s0 = sc[nt][j] * scale;
        float s1 = sc[nt][2 + j] * scale;
        if (kpos >= s || (causal && kpos > qpos0)) s0 = kNegInf;
        if (kpos >= s || (causal && kpos > qpos1)) s1 = kNegInf;
        sc[nt][j] = s0;
        sc[nt][2 + j] = s1;
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
    }
    // a row's 4 column pairs live in the 4 lanes of one quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0);
    const float c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[nt][j] = expf(sc[nt][j] - mn0);
        sc[nt][2 + j] = expf(sc[nt][2 + j] - mn1);
        ps0 += sc[nt][j];
        ps1 += sc[nt][2 + j];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd) {
      acc[nd][0] *= c0;
      acc[nd][1] *= c0;
      acc[nd][2] *= c1;
      acc[nd][3] *= c1;
    }

    // P V: the score accumulator of key tiles 2kk, 2kk+1 is exactly the A
    // fragment of the 16-deep product step kk
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t a0 = pack_f32(sc[2 * kk][0], sc[2 * kk][1]);
      const uint32_t a1 = pack_f32(sc[2 * kk][2], sc[2 * kk][3]);
      const uint32_t a2 = pack_f32(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const uint32_t a3 = pack_f32(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd) {
        const bf16* p = vs + (kk * 16 + t * 2) * LD + nd * 8 + g;
        mma_16816(acc[nd], a0, a1, a2, a3, pack_bf16(p[0], p[LD]),
                  pack_bf16(p[8 * LD], p[9 * LD]));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  bf16* oh = o + (size_t)h * s * D;
#pragma unroll
  for (int nd = 0; nd < NDT; ++nd) {
    const int col = nd * 8 + t * 2;
    if (qpos0 < s) {
      *reinterpret_cast<uint32_t*>(oh + (size_t)qpos0 * D + col) =
          pack_f32(acc[nd][0] / d0, acc[nd][1] / d0);
    }
    if (qpos1 < s) {
      *reinterpret_cast<uint32_t*>(oh + (size_t)qpos1 * D + col) =
          pack_f32(acc[nd][2] / d1, acc[nd][3] / d1);
    }
  }
}

template <int BQ, int BK, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int hq, int hkv, int s, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t kSmem = (size_t)(BQ + 2 * BK) * (D + kPad) * sizeof(bf16);
  auto kern = flash_fwd_kernel<BQ, BK, D>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((s + BQ - 1) / BQ, bh);
  kern<<<grid, BQ * 2, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), hq, hkv, s, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int bq, int bk, const void* q, const void* k,
                     const void* v, void* o, int bh, int hq, int hkv, int s,
                     float scale, int causal, cudaStream_t st) {
#define FLASH_CASE(BQ_, BK_)                                                \
  if (bq == BQ_ && bk == BK_)                                               \
    return launch<BQ_, BK_, D>(q, k, v, o, bh, hq, hkv, s, scale, causal, st);
#define FLASH_ROW(BQ_) \
  FLASH_CASE(BQ_, 16) FLASH_CASE(BQ_, 32) FLASH_CASE(BQ_, 64) FLASH_CASE(BQ_, 128)
  FLASH_ROW(16) FLASH_ROW(32) FLASH_ROW(64) FLASH_ROW(128)
#undef FLASH_ROW
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: [b, hq, s, d]; k, v: [b, hkv, s, d]; bf16, contiguous, 16-byte
// aligned. Built for d in {64, 128} and block_q, block_k in {16, 32, 64, 128};
// anything else returns cudaErrorInvalidValue without launching.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, int b, int hq,
                                        int hkv, int s, int d, int block_q,
                                        int block_k, float scale, int causal,
                                        void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || s <= 0 || hq % hkv != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return dispatch<64>(block_q, block_k, q, k, v, o, b * hq, hq, hkv, s,
                          scale, causal, st);
    case 128:
      return dispatch<128>(block_q, block_k, q, k, v, o, b * hq, hq, hkv, s,
                           scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}
