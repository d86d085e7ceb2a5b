// Flash-attention forward for Hopper (sm_90a) at head dims 129-256, bf16
// and f16: the generic builds of flash_attention.cuh at padded widths 192
// and 256 (the head dim passed at run time, TMA's zero fill past it), in a
// library of their own so that the build compiles them beside the narrow
// ones. flash_attention.cuh says how the widths are laid out and why
// these blocks.
//
// Replaces the TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py,
// launched by `flash_attention_pallas`) at head dims past 128.
//
// Bound on this card: Gemma 7B's attention (16/16 heads of 256) at S=1024
// causal is 4*16*1024*1025/2*256 ~ 8.6 GFLOP, 8.7 us at 989 TFLOP/s,
// against 33.6 MB of q/k/v/o, 10.0 us at 3.35 TB/s: the bytes bound it by
// a little; with 8 key heads (16/8) the bytes fall to 25 MB and the tensor
// cores bound it. Either way the design is the narrow kernel's.

#include "flash_attention.cuh"

namespace {

// one instantiation per (BQ, BK, padded width DP) whose shared memory fits
// one block, in each 16-bit type
#define FLASH_WIDE_BUILT(X) \
  X(64, 64, 192) X(64, 128, 192) X(128, 64, 192) \
  X(64, 64, 256) X(128, 64, 256)

// a head dim past 128 that these builds take: a multiple of 8 up to 256
bool wide_head_dim_ok(int d) { return d > 128 && d <= 256 && d % 8 == 0; }

template <typename T>
int wide_fwd(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
             int s, int d, int block_q, int block_k, float scale, int causal, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || s <= 0 || hq % hkv != 0 || !wide_head_dim_ok(d)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE_WIDE(BQ_, BK_, DP_)                                           \
  if (padded(d) == DP_ && block_q == BQ_ && block_k == BK_)                      \
    return launch<T, BQ_, BK_, 0, DP_>(q, k, v, o, b, hq, hkv, s, d, scale, causal, st);
  FLASH_WIDE_BUILT(FLASH_CASE_WIDE)
#undef FLASH_CASE_WIDE
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of the kernel that runs head dim d (129-256) at
// (block_q, block_k), in bytes, in either 16-bit type, or -1 when none is
// built for them.
extern "C" int flash_attention_wide_smem_bytes(int d, int block_q, int block_k) {
  if (!wide_head_dim_ok(d)) return -1;
#define FLASH_SMEM_WIDE(BQ_, BK_, DP_) \
  if (padded(d) == DP_ && block_q == BQ_ && block_k == BK_) return Cfg<BQ_, BK_, 0, DP_>::kSmem;
  FLASH_WIDE_BUILT(FLASH_SMEM_WIDE)
#undef FLASH_SMEM_WIDE
  return -1;
}

// q, o: [b, hq, s, d]; k, v: [b, hkv, s, d]; bf16, contiguous, 16-byte
// aligned; d a multiple of 8 from 136 to 256 and (block_q, block_k) in
// FLASH_WIDE_BUILT at d's padded width. Anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_wide_fwd_bf16(const void* q, const void* k, const void* v,
                                             void* o, int b, int hq, int hkv, int s, int d,
                                             int block_q, int block_k, float scale,
                                             int causal, void* stream) {
  return wide_fwd<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, d, block_q, block_k, scale,
                                 causal, stream);
}

// The same in f16.
extern "C" int flash_attention_wide_fwd_f16(const void* q, const void* k, const void* v,
                                            void* o, int b, int hq, int hkv, int s, int d,
                                            int block_q, int block_k, float scale,
                                            int causal, void* stream) {
  return wide_fwd<__half>(q, k, v, o, b, hq, hkv, s, d, block_q, block_k, scale, causal,
                          stream);
}
