// Blocked matrix product for Hopper (sm_90a) in f16: the 16-bit kernel of
// matmul.cuh instantiated for __half at every configuration the bf16
// library builds (MM_BUILT), in a library of its own so that the build
// compiles it beside the bf16 one. Its design, bound and ragged tiles are
// bf16's: the tensor cores take f16 at the same shapes and rate.
//
// Replaces the TPU kernel `_matmul_kernel` (src/repro/kernels/matmul.py,
// launched by `matmul_pallas`) for float16 inputs.

#include "matmul.cuh"

// matmul_smem_bytes for the f16 instantiations.
extern "C" int matmul_f16_smem_bytes(int bm, int bn, int bk, int double_buffer) {
  return mm16_smem_bytes(bm, bn, bk, double_buffer);
}

// matmul_bf16's arguments and rules, with a, b and c f16.
extern "C" int matmul_f16(const void* a, const void* b, void* c, int m, int n, int k,
                          int bm, int bn, int bk, int double_buffer, void* stream) {
  return mm16<__half>(a, b, c, m, n, k, bm, bn, bk, double_buffer, stream);
}
