// Hopper (sm_90a) building blocks shared by the port's attention kernels
// and its quantized reduce: mbarriers, TMA tile loads and 1-D bulk copies,
// the host code that encodes the tile loads' tensor maps, wgmma
// shared-memory descriptors and the wgmma.mma_async products for bf16
// inputs with f32 accumulators.
//
// Conventions (PTX ISA, "Asynchronous Warpgroup Level Matrix Instructions"):
// - A tile loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B is stored as rows
//   of 128 bytes (64 bf16) in atoms of 8 rows (1024 bytes); the 16-byte
//   chunk c of row r sits at chunk c ^ (r % 8).  Wider rows are split into
//   64-column boxes, each box a separate [rows][64] region.  Every region
//   starts on a 1024-byte boundary, so the descriptors' base offset is 0.
// - m64nNk16 accumulator: thread t of the warpgroup (warp w = t / 32, lane
//   l) holds d[4j + 0..1] at row 16w + l/4, columns 8j + 2(l%4) + {0, 1},
//   and d[4j + 2..3] at row 16w + l/4 + 8, the same columns (j < N / 8).
// - Register A fragment of one k16 slice (RS products): a[0] = row l/4,
//   columns 2(l%4) + {0, 1}; a[1] = row l/4 + 8; a[2], a[3] = the same rows,
//   columns + 8; two bf16 a register, the lower column in the low half.  So
//   accumulator registers d[8k .. 8k + 7] of an m64nN product, packed in
//   pairs, are the A fragment of its k-th 16-column slice.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA); follow
// it with a __syncthreads() before any thread uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects ``bytes`` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity ``parity`` has completed.  A
// freshly initialised barrier is in phase 0, so waiting on parity 1 passes
// at once.  A phase that never completes is a bug in the caller's ring;
// after ~10 s of spinning the kernel traps (a launch error) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Copy the box at coordinates (c0, c1, c2) (innermost first) of a 3-D
// tensor map into shared memory at ``dst``; its bytes complete a
// transaction count on ``bar``.  Out-of-bounds elements are written as 0.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Copy ``bytes`` contiguous bytes of global memory at ``src`` into shared
// memory at ``dst`` with one bulk copy (no tensor map); its bytes complete a
// transaction count on ``bar``.  Both addresses 16-byte aligned, ``bytes`` a
// multiple of 16.
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand.  Byte
// strides, as the PTX ISA's canonical layouts name them:
// - K-major (the reduction dim contiguous): sbo = bytes between 8-row
//   groups (1024 for dense 128-byte rows); lbo is unused (16).  Step along
//   K inside a 64-column box by adding 32 bytes per k16 slice to ``p``.
// - MN-major (the M or N dim contiguous): sbo = bytes between 8-row groups
//   along K (1024); lbo = bytes between 64-column boxes along M or N.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;  // layout type 1: 128-byte swizzle
}

// the descriptor of the same operand ``bytes`` further on (a multiple of
// 16): shared addresses stay under 256 KB, so the 14-bit start address
// field does not carry into the strides
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// a copy of ``x`` the compiler cannot see through: descriptors derived from
// it inside a loop are rebuilt there with one add each, instead of being
// hoisted out of the loop and held in registers the accumulators need
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// before the first wgmma, and between ordinary writes of its accumulator or
// A registers and the wgmma that reads them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of wgmma registers across the
// asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_ACC8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_ACC32(d) SM90_ACC8(d, 0), SM90_ACC8(d, 8), SM90_ACC8(d, 16), SM90_ACC8(d, 24)
#define SM90_ACC64(d) SM90_ACC32(d), SM90_ACC8(d, 32), SM90_ACC8(d, 40), SM90_ACC8(d, 48), \
                      SM90_ACC8(d, 56)

// d (+)= A · B, m64nNk16, A and B in shared memory, A K-major; B K-major
// (TRANS_B = 0) or MN-major (TRANS_B = 1).  scale_d = 0 overwrites d.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "instantiated for N = 64, 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : SM90_ACC32(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n"
        "}\n"
        : SM90_ACC64(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
}

// d (+)= A · B, m64nNk16, A from registers (the fragment above), B in
// shared memory, K-major (TRANS_B = 0) or MN-major (TRANS_B = 1)
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "instantiated for N = 64, 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : SM90_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : SM90_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(TRANS_B));
  }
}

#undef SM90_ACC8
#undef SM90_ACC32
#undef SM90_ACC64

// ---------------------------------------------------------------------------
// TMA tensor maps (host)
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 3-D map over a contiguous [heads, rows, D] bf16 tensor with
// [box_rows][64] boxes (64 columns: 128 bytes, the swizzle span) swizzled by
// 128 bytes; zero fill past each head's last row
inline bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int D, int rows,
                     int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
