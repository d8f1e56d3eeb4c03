// The AVG divide of a summed gradient bucket on Hopper (sm_90a), written
// straight into a .grad leaf.
//
// Replaces no Pallas kernel: it takes the place of the host divide of
// torchft_tpu/manager.py (_div, and bf16 as ml_dtypes divides it), which the
// port ran on the host after each ring (torchft_tpu_torch/bf16.py:div) and
// followed with a copy of the quotient back to the card.  Here the summed
// bucket comes back to the card as it left the ring, and one pass divides it
// by the participant count and stores each element in its leaf's dtype.
//
// The arithmetic is the host's, bit for bit:
//   - a bf16 sum widens exactly to f32 (its bits << 16);
//   - the quotient is the IEEE f32 division by the divisor, rounded to
//     nearest even (__fdiv_rn; the build keeps denormals);
//   - a bf16 result rounds the f32 quotient to nearest even on its bits
//     (c10's round_to_nearest_even, which torch's CPU cast uses);
//   - a NaN sum gives ml_dtypes' quiet NaN with the sum's sign into bf16
//     (0x7fc0 / 0xffc0), and into f32 the sum itself made quiet (x86 returns
//     a NaN operand of a division with bit 22 set).  CUDA's own division and
//     its bf16 conversion would give the card's canonical positive NaN.
//
// What bounds it on an H100: one division per element and a few bytes read
// and written, far below the ridge, so bytes at 3.35 TB/s (the whole 2-layer
// Llama-3-8B-width gradient, bf16 into bf16: 5.95 GB, ~1.8 ms).  Each thread
// handles a run of 8 elements with 16-byte loads and stores where the run is
// whole and both ends aligned (every run of a bucket whose leaves start on
// 16 bytes); a ragged or unaligned run goes element by element.
//
// src and dst may be one buffer (the copy-back divides each leaf in place):
// every element is loaded once, by the thread that then stores it, so the
// loads are plain ones (no read-only cache) and the pointers not restrict.
//
// The entry point returns cudaGetLastError() after its launch (0 = ok), or
// -1 for a bad kind, size or divisor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_F32 = 0;
constexpr int KIND_BF16 = 1;
constexpr int THREADS = 256;
constexpr int RUN = 8;  // elements a thread handles per step

__device__ __forceinline__ uint32_t bf16_bits(float x, float q) {
  if (x != x) {  // NaN sum: ml_dtypes' quiet NaN, the sum's sign
    return ((__float_as_uint(x) >> 16) & 0x8000u) | 0x7fc0u;
  }
  const uint32_t u = __float_as_uint(q);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float f32_value(float x, float q) {
  return (x != x) ? __uint_as_float(__float_as_uint(x) | 0x00400000u) : q;
}

// a run of RUN elements: whole and 16-byte aligned -> vector loads and
// stores; else element by element up to n
__device__ __forceinline__ void load_run(const uint16_t* src, int64_t base, int64_t n, bool vec,
                                         float (&x)[RUN]) {
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + base);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    x[k] = (base + k < n) ? __uint_as_float(static_cast<uint32_t>(src[base + k]) << 16) : 0.f;
  }
}

__device__ __forceinline__ void load_run(const float* src, int64_t base, int64_t n, bool vec,
                                         float (&x)[RUN]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(src + base);
    const float4 b = *reinterpret_cast<const float4*>(src + base + 4);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < RUN; ++k) x[k] = (base + k < n) ? src[base + k] : 0.f;
}

__device__ __forceinline__ void store_run(uint16_t* dst, int64_t base, int64_t n, bool vec,
                                          const float (&x)[RUN], const float (&q)[RUN]) {
  if (vec) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = bf16_bits(x[2 * k], q[2 * k]) | (bf16_bits(x[2 * k + 1], q[2 * k + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(dst + base) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    if (base + k < n) dst[base + k] = static_cast<uint16_t>(bf16_bits(x[k], q[k]));
  }
}

__device__ __forceinline__ void store_run(float* dst, int64_t base, int64_t n, bool vec,
                                          const float (&x)[RUN], const float (&q)[RUN]) {
  if (vec) {
    *reinterpret_cast<float4*>(dst + base) =
        make_float4(f32_value(x[0], q[0]), f32_value(x[1], q[1]), f32_value(x[2], q[2]),
                    f32_value(x[3], q[3]));
    *reinterpret_cast<float4*>(dst + base + 4) =
        make_float4(f32_value(x[4], q[4]), f32_value(x[5], q[5]), f32_value(x[6], q[6]),
                    f32_value(x[7], q[7]));
    return;
  }
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    if (base + k < n) dst[base + k] = f32_value(x[k], q[k]);
  }
}

template <typename S, typename D>
__global__ void __launch_bounds__(THREADS)
    average_kernel(const S* src, D* dst, int64_t n, float divisor) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS * RUN;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * RUN; base < n;
       base += stride) {
    const bool vec = base + RUN <= n &&
                     ((reinterpret_cast<uintptr_t>(src + base) |
                       reinterpret_cast<uintptr_t>(dst + base)) & 15) == 0;
    float x[RUN], q[RUN];
    load_run(src, base, n, vec, x);
#pragma unroll
    for (int k = 0; k < RUN; ++k) q[k] = __fdiv_rn(x[k], divisor);
    store_run(dst, base, n, vec, x, q);
  }
}

template <typename S, typename D>
void launch(const void* src, void* dst, int64_t n, float divisor, cudaStream_t st) {
  const int64_t runs = (n + RUN - 1) / RUN;
  const int64_t blocks = (runs + THREADS - 1) / THREADS;
  const unsigned grid = static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
  average_kernel<S, D><<<grid, THREADS, 0, st>>>(static_cast<const S*>(src),
                                                  static_cast<D*>(dst), n, divisor);
}

}  // namespace

extern "C" {

// dst[i] = src[i] / divisor for i < n, src and dst each f32 (kind 0) or
// bf16 (kind 1); divisor >= 1 (exact in f32 below 2^24).
int tft_average_into(const void* src, int src_kind, void* dst, int dst_kind, long long n,
                     long long divisor, void* stream) {
  if (n < 0 || divisor < 1 || divisor > (1 << 24)) return -1;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float d = static_cast<float>(divisor);
  if (src_kind == KIND_BF16 && dst_kind == KIND_BF16) {
    launch<uint16_t, uint16_t>(src, dst, n, d, st);
  } else if (src_kind == KIND_F32 && dst_kind == KIND_F32) {
    launch<float, float>(src, dst, n, d, st);
  } else if (src_kind == KIND_F32 && dst_kind == KIND_BF16) {
    launch<float, uint16_t>(src, dst, n, d, st);
  } else if (src_kind == KIND_BF16 && dst_kind == KIND_F32) {
    launch<uint16_t, float>(src, dst, n, d, st);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tft_average_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
