// Hopper (sm_90a) primitives as inline PTX, shared by the port's kernels:
// mbarriers, TMA tensor loads, wgmma with shared-memory descriptors, and
// setmaxnreg; and, on the host, the TMA tensor maps both kernels load
// through. Plain PTX keeps the build to one nvcc call per source with no
// include path beyond the CUDA toolkit's.
//
// Conventions used by the callers:
// - The 16-bit element type T is __nv_bfloat16 or __half: wgmma, TMA and
//   the packed stores take either at the same shapes and rate.
// - Tiles are stored as 128-byte-swizzled atoms: rows of 64 16-bit
//   elements (128 B), 8 rows (1024 B) per swizzle period, each atom
//   1024-byte aligned. A row wider than 64 elements is split into column
//   blocks of 64, each block a tile of its own. TMA writes this layout
//   with CU_TENSOR_MAP_SWIZZLE_128B and a box 64 elements wide; wgmma
//   reads it through a descriptor with layout type B128.
// - Shared addresses are 32-bit (`__cvta_generic_to_shared`).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// makes initialised barriers visible to the async proxy and the other threads
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival, and `bytes` more expected from asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// true once the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity`. (A timeout that traps, with
// clock64, would make ptxas spill around wgmma and serialize it; a stuck
// pipeline hangs instead, and a caller's time limit ends it.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// orders generic-proxy writes to shared memory before later async-proxy
// (TMA, wgmma) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------- named barriers

// Hardware barrier `id` (1..15; 0 is __syncthreads) over `threads` threads:
// sync waits until that many have arrived, arrive counts without waiting.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ----------------------------------------------------------------------- TMA

// box at coordinates (c0 innermost, c1, c2) of `map` into shared memory at
// `dst`; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// --------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor for a 128-byte-swizzled operand.
// lbo/sbo are in bytes: for a K-major operand sbo is the stride between
// 8-row groups (1024 B) and lbo is unused; for an MN-major operand lbo is
// the stride between 64-element column blocks along M/N and sbo the stride
// between groups of 8 rows along K (1024 B).
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr, uint32_t lbo,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);  // layout type 1: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving ordinary reads or writes of a register
// across the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define HOPPER_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_D32 HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
#define HOPPER_D64 HOPPER_D32, HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
#define HOPPER_D96 \
  HOPPER_D64, HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88)
#define HOPPER_D128                                                          \
  HOPPER_D64, HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88),     \
      HOPPER_D8(96), HOPPER_D8(104), HOPPER_D8(112), HOPPER_D8(120)
#define HOPPER_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}, "
#define HOPPER_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}, "
#define HOPPER_REGS96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
#define HOPPER_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}, "

// D[64 x N] (+)= A[64 x 16] * B[16 x N], T (bf16 or f16) in, f32
// accumulator, both operands in shared memory. A is K-major; B is K-major
// (TRANS_B = 0) or MN-major (TRANS_B = 1). scale_d = 0 overwrites D. The
// two element types share every fragment layout; only the PTX names them.
template <typename T, int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d);

// D[64 x N] (+)= A[64 x 16] * B[16 x N] with A in registers: the four
// 32-bit registers of a thread hold the m16n8k16 A fragment of its warp's
// 16 rows (a0: row g, cols 2t..2t+1; a1: row g+8; a2: row g, cols 2t+8..;
// a3: row g+8, cols 2t+8..; g = lane / 4, t = lane % 4), the same layout as
// a 16-column slice of the f32 accumulator once packed to T pairs.
template <typename T, int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);

// One specialization per element type, N and B's major-ness. DREGS/REGS
// are the accumulator's operands and their list; A, B and P number the
// descriptors (or A's registers) and the scale-d predicate after them.
#define HOPPER_WGMMA_SS(T, PTX, N, TRANS_B, DREGS, REGS, A, B, P)                        \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_ss<T, N, TRANS_B>(                             \
      float(&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                      \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX "." PTX " " REGS \
                 "%" #A ", %" #B ", p, 1, 1, 0, " #TRANS_B ";\n}\n"                    \
                 : DREGS                                                               \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                            \
  }
#define HOPPER_WGMMA_RS(T, PTX, N, TRANS_B, DREGS, REGS, A0, A1, A2, A3, B, P)            \
  template <>                                                                          \
  __device__ __forceinline__ void wgmma_rs<T, N, TRANS_B>(                              \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t desc_b, int scale_d) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                       \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX "." PTX " " REGS  \
                 "{%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, " #TRANS_B \
                 ";\n}\n"                                                               \
                 : DREGS                                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),             \
                   "r"(scale_d));                                                       \
  }
#define HOPPER_WGMMA_FORMS(T, PTX)                                                    \
  HOPPER_WGMMA_SS(T, PTX, 64, 0, HOPPER_D32, HOPPER_REGS32, 32, 33, 34)                \
  HOPPER_WGMMA_SS(T, PTX, 128, 0, HOPPER_D64, HOPPER_REGS64, 64, 65, 66)              \
  /* B MN-major: row-major [K][N] tiles read through the transpose bit */            \
  HOPPER_WGMMA_SS(T, PTX, 64, 1, HOPPER_D32, HOPPER_REGS32, 32, 33, 34)                \
  HOPPER_WGMMA_SS(T, PTX, 128, 1, HOPPER_D64, HOPPER_REGS64, 64, 65, 66)              \
  HOPPER_WGMMA_SS(T, PTX, 256, 1, HOPPER_D128, HOPPER_REGS128, 128, 129, 130)         \
  HOPPER_WGMMA_RS(T, PTX, 64, 1, HOPPER_D32, HOPPER_REGS32, 32, 33, 34, 35, 36, 37)    \
  HOPPER_WGMMA_RS(T, PTX, 128, 1, HOPPER_D64, HOPPER_REGS64, 64, 65, 66, 67, 68, 69)   \
  HOPPER_WGMMA_RS(T, PTX, 192, 1, HOPPER_D96, HOPPER_REGS96, 96, 97, 98, 99, 100, 101) \
  HOPPER_WGMMA_RS(T, PTX, 256, 1, HOPPER_D128, HOPPER_REGS128, 128, 129, 130, 131, 132, \
                  133)

HOPPER_WGMMA_FORMS(__nv_bfloat16, "bf16")
HOPPER_WGMMA_FORMS(__half, "f16")

#undef HOPPER_WGMMA_FORMS
#undef HOPPER_WGMMA_SS
#undef HOPPER_WGMMA_RS
#undef HOPPER_D8
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_D96
#undef HOPPER_D128
#undef HOPPER_REGS32
#undef HOPPER_REGS64
#undef HOPPER_REGS96
#undef HOPPER_REGS128

// two floats rounded to nearest as a packed pair of T (the low half first)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ----------------------------------------------------------------- setmaxnreg

// Every warp of the warpgroup executes these together; REGS is a multiple
// of 8 in [24, 256].
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled is a driver function; the libraries link only the
// CUDA runtime, so it is fetched through the runtime's entry-point query.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// TMA's name for a 16-bit element type
template <typename T>
constexpr CUtensorMapDataType tma_type();
template <>
constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <>
constexpr CUtensorMapDataType tma_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// [bh, s, d] of T (bf16 or f16), read in boxes of 64 columns x `rows`
// rows, 128B-swizzled; out-of-range rows read as zeros
template <typename T>
inline bool make_map(CUtensorMap* map, const void* ptr, int bh, int s, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, tma_type<T>(), 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [outer, rows, cols] f32, read in unswizzled boxes of `box_rows` x
// `box_cols` (each at most 256; box_cols * 4 a multiple of 16 B), written
// densely, row-major, into shared memory; out-of-range elements read as
// zeros
inline bool make_map_f32(CUtensorMap* map, const void* ptr, int outer, int rows, int cols,
                         int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)rows * cols * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
