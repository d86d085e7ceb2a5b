// Flash-attention forward for Hopper (sm_90a) in f16 at head dims up to
// 128: the 16-bit kernel of flash_attention.cuh instantiated for __half,
// at every configuration the bf16 library builds (FLASH_BUILT,
// FLASH_ANY_D_BUILT), in a library of its own so that the build compiles
// it beside the bf16 one. Its design and bound are bf16's (the tensor
// cores take f16 at the same shapes and rate); P is cast to f16, v's
// type, before P V, as the reference casts p to v's dtype.
//
// Replaces the TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py,
// launched by `flash_attention_pallas`) for float16 inputs.

#include "flash_attention.cuh"

// Dynamic shared memory of the f16 kernel that runs head dim d at
// (block_q, block_k), in bytes, or -1 when none is built for them.
extern "C" int flash_attention_f16_smem_bytes(int d, int block_q, int block_k) {
  return narrow_smem_bytes(d, block_q, block_k);
}

// flash_attention_fwd_bf16's arguments and rules, with q, k, v and o f16.
extern "C" int flash_attention_fwd_f16(const void* q, const void* k, const void* v,
                                       void* o, int b, int hq, int hkv, int s, int d,
                                       int block_q, int block_k, float scale, int causal,
                                       void* stream) {
  return narrow_fwd<__half>(q, k, v, o, b, hq, hkv, s, d, block_q, block_k, scale, causal,
                            stream);
}
