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
// The f32 kernel (`flash_attention_fwd_f32`, below) is SIMT:
// true f32 products by FFMA. TF32 tensor-core products miss the reference's
// f32 tolerance (atol 3e-5, rtol 3e-4), and wgmma takes tf32 operands only
// K-major, which V is not. Its bound is the FP32 rate, 67 TFLOP/s: at yi-6b's
// heads with S=1024 causal, 8.6 GFLOP take 128 us against 38 MB of q/k/v/o,
// 11 us at 3.35 TB/s, so the products bound it and the design keeps the
// FFMA units fed from shared memory:
//
// - One block per (batch*q-head, q-tile), the bf16 kernel's grid and GQA row
//   map; BQ/8 warps of 8 query rows each (256 or 512 threads).
// - Q, and a ring of two K/V stages, are copied into shared memory with
//   16-byte cp.async (zero-filled past S), so tile i+1 lands while tile i is
//   multiplied.
// - S = Q K^T: lane l of a warp owns keys l, l+32, ...; each step reads a
//   float4 of Q (one address for the warp: a broadcast) and a float4 of
//   each of its keys. K rows are stored with their 16-byte chunks XOR-
//   swizzled by key % 8, so the eight lanes of a quarter-warp hit distinct
//   banks with no padding.
// - The online softmax runs in registers in the log2 domain (the bf16
//   kernel's scale fold, mask and causal tile skip); each warp writes its
//   rows of P to shared memory, and O += P V reads P as float4 broadcasts
//   and V rows as 32 consecutive floats. Lane l owns output columns l,
//   l+32, ..., below DP; the columns past d are zero in V and never
//   stored.
// - Shared memory: 4 * (DP * (BQ + 4 * BK) + BQ * BK) bytes, built at the
//   (BQ, BK, DP) that fit one block's 232,448.
// - Widths 192 and 256 (head dims 136-256): two stages fit at no block
//   pair (262,144 B at (64, 64) and 192), so these builds keep one K/V
//   stage, 4 * (DP * (BQ + 2 * BK) + BQ * BK) bytes, and tile i+1 is copied
//   only once every warp is done with tile i: the copy no longer overlaps
//   the products. BQ is 64: at BQ = 128 the block's 512 threads get at most
//   128 registers each, (128, 64) at width 128 already takes 126, and 6 or
//   8 accumulator columns a lane would spill. Built at (64, 64) at 192 and
//   256 ((64, 128) needs 278,528 B at 192).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- f32, SIMT

// 16-byte asynchronous copy global -> shared; `bytes` < 16 zero-fills the
// rest (0: all zeros, nothing read)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BQ, int BK, int DP, int ST = 2>
struct CfgF32 {
  static_assert(BQ == 64 || BQ == 128, "BQ is 8 or 16 warps of 8 rows");
  static_assert(BK == 64 || BK == 128, "BK is 2 or 4 keys a lane");
  static_assert(DP == 64 || DP == 128 || DP == 192 || DP == 256,
                "DP is 2, 4, 6 or 8 columns a lane");
  static_assert(ST == 1 || ST == 2, "one or two K/V stages");
  static constexpr int kStages = ST;
  static constexpr int kRows = 8;                 // query rows a warp owns
  static constexpr int kThreads = 32 * BQ / kRows;
  static constexpr int kKJ = BK / 32;             // keys a lane owns
  static constexpr int kDJ = DP / 32;             // output columns a lane owns
  // floats: Q [BQ][DP], then per stage K [BK][DP] (swizzled) and V [BK][DP],
  // then P [BQ][BK]
  static constexpr int kKV = BK * DP;
  static constexpr int kKOff = BQ * DP;
  static constexpr int kPOff = kKOff + ST * 2 * kKV;
  static constexpr int kSmem = 4 * (kPOff + BQ * BK);
  static_assert(kSmem == 4 * (DP * (BQ + 2 * ST * BK) + BQ * BK), "the pickers' count");
  static_assert(kSmem <= 232448, "fits one block's shared memory");
};

template <int BQ, int BK, int DP, int ST>
__global__ void __launch_bounds__(CfgF32<BQ, BK, DP, ST>::kThreads, 1)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int hq,
                         int hkv, int s, int d, float scale_log2, int causal) {
  using C = CfgF32<BQ, BK, DP, ST>;
  constexpr int R = C::kRows, KJ = C::kKJ, DJ = C::kDJ;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const uint32_t smem_base = smem_u32(smem);
  float* q_s = smem;
  float* p_s = smem + C::kPOff;
  auto k_off = [&](int st) { return C::kKOff + st * 2 * C::kKV; };
  auto v_off = [&](int st) { return k_off(st) + C::kKV; };

  const int h = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int kvrow = (h / hq) * hkv + (h % hq) / (hq / hkv);
  const int nk = (s + BK - 1) / BK;
  const int n_tiles = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const int tid = threadIdx.x;
  const int nc = d / 4;  // 16-byte chunks in a row

  // V's columns d..DP-1 are never loaded: zero them once in every stage,
  // so the accumulator's columns past d stay zero
  for (int st = 0; st < ST; ++st) {
    for (int e = tid; e < BK * (DP - d); e += C::kThreads) {
      const int row = e / (DP - d);
      smem[v_off(st) + row * DP + d + e % (DP - d)] = 0.f;
    }
  }
  const float* qh = q + (size_t)h * s * d;
  const float* kh = k + (size_t)kvrow * s * d;
  const float* vh = v + (size_t)kvrow * s * d;
  // rows past S read as zeros (and nothing is read for them)
  auto load_rows = [&](const float* src, int row0, int n, int dst, bool swizzle) {
    for (int e = tid; e < n * nc; e += C::kThreads) {
      const int row = e / nc, c = e % nc;
      const int g = row0 + row;
      const int sc = swizzle ? (c ^ (row & 7)) : c;
      cp_async_16(smem_base + 4u * (dst + row * DP + 4 * sc),
                  src + (size_t)min(g, s - 1) * d + 4 * c, g < s ? 16 : 0);
    }
  };
  auto load_kv = [&](int i) {
    load_rows(kh, i * BK, BK, k_off(i % ST), true);
    load_rows(vh, i * BK, BK, v_off(i % ST), false);
  };
  load_rows(qh, q0, BQ, 0, false);
  load_kv(0);
  cp_async_commit();
  if (ST == 2 && n_tiles > 1) {
    load_kv(1);
    cp_async_commit();
  }

  const int w = tid / 32, lane = tid % 32;
  const int r0 = w * R;  // the warp's first row in the tile
  float acc[R][DJ], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    if (ST == 2 && i + 1 < n_tiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i (and Q) landed for every thread's copies
    const float* k_s = smem + k_off(i % ST);
    const float* v_s = smem + v_off(i % ST);

    // S = Q K^T over the d columns: a float4 of Q (broadcast) against a
    // float4 of each of the lane's keys; chunk c of key row j lies at chunk
    // c ^ (j % 8), and j % 8 == lane % 8
    float sc[R][KJ];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < KJ; ++j) sc[r][j] = 0.f;
    }
    for (int c = 0; c < nc; ++c) {
      float4 kv[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(
            k_s + (lane + 32 * j) * DP + 4 * (c ^ (lane & 7)));
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (r0 + r) * DP + 4 * c);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          sc[r][j] = fmaf(qv.x, kv[j].x, sc[r][j]);
          sc[r][j] = fmaf(qv.y, kv[j].y, sc[r][j]);
          sc[r][j] = fmaf(qv.z, kv[j].z, sc[r][j]);
          sc[r][j] = fmaf(qv.w, kv[j].w, sc[r][j]);
        }
      }
    }

    // online softmax in the log2 domain; P to this warp's rows of p_s
    const int k0 = i * BK;
    const bool mask = k0 + BK > s || (causal && k0 + BK - 1 > q0 + r0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = q0 + r0 + r;
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float x = sc[r][j] * scale_log2;
        if (mask) {
          const int key = k0 + lane + 32 * j;
          if (key >= s || (causal && key > row)) x = kNegInf;
        }
        sc[r][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float corr = exp2_ftz(m[r] - mx);
      m[r] = mx;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = exp2_ftz(sc[r][j] - mx);
        p_s[(r0 + r) * BK + lane + 32 * j] = p;
        ps += p;
      }
      l[r] = l[r] * corr + ps;  // this lane's share of the row sum
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[r][j] *= corr;
    }
    __syncwarp();

    // O += P V: four keys a step, P as a float4 broadcast per row
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float vv[4][DJ];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[e][j] = v_s[(kk + e) * DP + lane + 32 * j];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(p_s + (r0 + r) * BK + kk);
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc[r][j] = fmaf(p.x, vv[0][j], acc[r][j]);
          acc[r][j] = fmaf(p.y, vv[1][j], acc[r][j]);
          acc[r][j] = fmaf(p.z, vv[2][j], acc[r][j]);
          acc[r][j] = fmaf(p.w, vv[3][j], acc[r][j]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage (and its P)
    if (i + ST < n_tiles) {
      load_kv(i + ST);
      cp_async_commit();
    }
  }

  float* oh = o + (size_t)h * s * d;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float sum = l[r];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + r0 + r;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = lane + 32 * j;
      if (row < s && col < d) oh[(size_t)row * d + col] = acc[r][j] * inv;
    }
  }
}

// ------------------------------------------------------------------- host

template <int BQ, int BK, int DP, int ST>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b,
                       int hq, int hkv, int s, int d, float scale, int causal,
                       cudaStream_t stream) {
  using C = CfgF32<BQ, BK, DP, ST>;
  auto kern = flash_fwd_f32_kernel<BQ, BK, DP, ST>;
  static bool raised[kMaxDevices] = {};
  cudaError_t err = raise_smem(kern, C::kSmem, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (s + BQ - 1) / BQ);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, s, d,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

// f32, every (BQ, BK, DP) whose shared memory fits one block: two K/V
// stages up to 128 columns, one past it, where BQ is 64 (registers)
#define FLASH_F32_BUILT(X) \
  X(64, 64, 64) X(64, 128, 64) X(128, 64, 64) X(128, 128, 64) \
  X(64, 64, 128) X(128, 64, 128) \
  X(64, 64, 192) X(64, 64, 256)

// the K/V stages of the f32 build at padded width DP
constexpr int f32_stages(int dp) { return dp > 128 ? 1 : 2; }

// a head dim the f32 kernel takes: a multiple of 8 from 8 to 256
inline bool f32_head_dim_ok(int d) { return d >= 8 && d <= 256 && d % 8 == 0; }

}  // namespace

// Dynamic shared memory of the bf16 kernel that runs head dim d at
// (block_q, block_k), in bytes, or -1 when none is built for them.
extern "C" int flash_attention_smem_bytes(int d, int block_q, int block_k) {
  return narrow_smem_bytes(d, block_q, block_k);
}

// The same for the f32 kernel.
extern "C" int flash_attention_f32_smem_bytes(int d, int block_q, int block_k) {
  if (!f32_head_dim_ok(d)) return -1;
#define FLASH_SMEM_F32(BQ_, BK_, DP_)                           \
  if (padded(d) == DP_ && block_q == BQ_ && block_k == BK_) \
    return CfgF32<BQ_, BK_, DP_, f32_stages(DP_)>::kSmem;
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
#define FLASH_CASE_F32(BQ_, BK_, DP_)                                            \
  if (padded(d) == DP_ && block_q == BQ_ && block_k == BK_)                      \
    return launch_f32<BQ_, BK_, DP_, f32_stages(DP_)>(q, k, v, o, b, hq, hkv, s, d, \
                                                      scale, causal, st);
  FLASH_F32_BUILT(FLASH_CASE_F32)
#undef FLASH_CASE_F32
  return cudaErrorInvalidValue;
}
