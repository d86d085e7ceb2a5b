// Flash-attention forward for Hopper (sm_90a) at head dims 257-512, bf16
// and f16: the generic builds of flash_attention.cuh at padded widths 384
// and 512 with the output's columns in two chunks (VW = DP / 2 each, one
// per blockIdx.z) and one K/V stage, in a library of their own so that the
// build compiles them beside the others. flash_attention.cuh says how the
// chunks are laid out and why these blocks.
//
// Replaces the TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py,
// launched by `flash_attention_pallas`) at head dims past 256.
//
// What bounds it: a 64-row warpgroup holds at most a 64 x 256 f32
// accumulator, so each block computes half the output's columns and
// repeats S = Q K^T for the other half: at DP = 512, 3 instead of 2 units
// of 2*S^2*D work (1.5x). With one K/V stage the loads of tile i+1 wait
// for tile i's products. At 16/16 heads of 512, S=1024 causal, the work is
// 4*16*1024*1025/2*512 ~ 17.2 GFLOP, 17.4 us at 989 TFLOP/s, against 67 MB
// of q/k/v/o, 20.0 us at 3.35 TB/s: the bytes bound the function, and the
// kernel's repeated products and unpipelined loads are its own cost.

#include "flash_attention.cuh"

namespace {

// one instantiation per (BQ, BK, padded width DP) whose shared memory fits
// one block, in each 16-bit type
#define FLASH_CHUNKED_BUILT(X) \
  X(64, 64, 384) X(64, 128, 384) X(128, 64, 384) \
  X(64, 64, 512) X(128, 64, 512)

// a head dim past 256 that these builds take: a multiple of 8 up to 512
bool chunked_head_dim_ok(int d) { return d > 256 && d <= 512 && d % 8 == 0; }

// the width a head dim past 256 is staged at: whole pairs of 64-column atoms
int chunked_padded(int d) { return (d + 127) / 128 * 128; }

template <typename T>
int chunked_fwd(const void* q, const void* k, const void* v, void* o, int b, int hq,
                int hkv, int s, int d, int block_q, int block_k, float scale, int causal,
                void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || s <= 0 || hq % hkv != 0 || !chunked_head_dim_ok(d)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE_CHUNKED(BQ_, BK_, DP_)                                              \
  if (chunked_padded(d) == DP_ && block_q == BQ_ && block_k == BK_)                    \
    return launch<T, BQ_, BK_, 0, DP_, DP_ / 2, 1>(q, k, v, o, b, hq, hkv, s, d, scale, \
                                                   causal, st);
  FLASH_CHUNKED_BUILT(FLASH_CASE_CHUNKED)
#undef FLASH_CASE_CHUNKED
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of the kernel that runs head dim d (257-512) at
// (block_q, block_k), in bytes, in either 16-bit type, or -1 when none is
// built for them.
extern "C" int flash_attention_chunked_smem_bytes(int d, int block_q, int block_k) {
  if (!chunked_head_dim_ok(d)) return -1;
#define FLASH_SMEM_CHUNKED(BQ_, BK_, DP_)                                   \
  if (chunked_padded(d) == DP_ && block_q == BQ_ && block_k == BK_)         \
    return Cfg<BQ_, BK_, 0, DP_, DP_ / 2, 1>::kSmem;
  FLASH_CHUNKED_BUILT(FLASH_SMEM_CHUNKED)
#undef FLASH_SMEM_CHUNKED
  return -1;
}

// q, o: [b, hq, s, d]; k, v: [b, hkv, s, d]; bf16, contiguous, 16-byte
// aligned; d a multiple of 8 from 264 to 512 and (block_q, block_k) in
// FLASH_CHUNKED_BUILT at d's padded width. Anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_chunked_fwd_bf16(const void* q, const void* k, const void* v,
                                                void* o, int b, int hq, int hkv, int s,
                                                int d, int block_q, int block_k,
                                                float scale, int causal, void* stream) {
  return chunked_fwd<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, d, block_q, block_k, scale,
                                    causal, stream);
}

// The same in f16.
extern "C" int flash_attention_chunked_fwd_f16(const void* q, const void* k, const void* v,
                                               void* o, int b, int hq, int hkv, int s,
                                               int d, int block_q, int block_k,
                                               float scale, int causal, void* stream) {
  return chunked_fwd<__half>(q, k, v, o, b, hq, hkv, s, d, block_q, block_k, scale, causal,
                             stream);
}
