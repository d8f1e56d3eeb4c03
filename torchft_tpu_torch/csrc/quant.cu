// Rowwise int8 / fp8 quantize and dequantize for Hopper (sm_90a).
//
// Replaces two of the three Pallas TPU kernels of torchft_tpu/ops/pallas_quant.py:
//   quantize   -> _quant_kernel   (launched by _pallas_quantize)
//   dequantize -> _dequant_kernel (launched by _pallas_dequant)
// The third, the fused reduce (_reduce_kernel), is csrc/quant_reduce_sm90.cu.
//
// Layout: a flat f32 buffer of n elements is viewed as rows of ROW = 1024;
// the payload is [rows, 1024] bytes (int8, or float8_e4m3fn bit patterns)
// and the scales [rows] f32, with rows padded by the caller to a multiple
// of 32 (the JAX package's geometry).  Elements past n read as zero; the
// kernels mask that ragged tail themselves, so no padded copy of the input
// is ever made.
//
// What bounds them on an H100: each is one pass over its operands with a
// handful of operations per byte, far below the ~295 FLOP/byte ridge, so
// the bound is bytes at 3.35 TB/s (quantize at the Llama-3-8B 2-layer
// gradient size: 5.95 GB read, 1.49 GB written, ~2.2 ms).  What the design
// does about it: one warp owns one row of 1024, each lane holds 32 elements
// in registers, so the input is read once with 16-byte loads, the absmax
// is a warp-shuffle reduction with no shared memory and no block barrier,
// and the payload is written once.  Eight rows (warps) per block.
//
// The wire arithmetic, and what keeps it bit-identical with the host wire,
// is csrc/quant.cuh.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok),
// or -1 for an unknown wire kind or a bad size.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

using namespace tftq;

constexpr int WARPS = 8;  // rows per block: warp i of the block owns one row
constexpr int THREADS = WARPS * 32;

template <int KIND>
__global__ void __launch_bounds__(THREADS)
    quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                    float* __restrict__ scales, int64_t n, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = row * ROW;
  float v[STEPS][VEC];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int64_t i = base + s * 128 + lane * VEC;
    if (i + VEC <= n) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(x + i));
      v[s][0] = f.x;
      v[s][1] = f.y;
      v[s][2] = f.z;
      v[s][3] = f.w;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[s][k] = (i + k < n) ? x[i + k] : 0.f;
    }
  }
  store_row<KIND>(v, q + base, scales + row, lane);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
    dequantize_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scales,
                      float* __restrict__ out, int64_t n, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = row * ROW;
  const float s_r = __ldg(scales + row);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int64_t i = base + s * 128 + lane * VEC;
    if (i >= n) break;
    const uint32_t packed = __ldg(reinterpret_cast<const uint32_t*>(q + i));
    float v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(decode<KIND>((packed >> (8 * k)) & 0xffu), s_r);
    if (i + VEC <= n) {
      *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (i + k < n) out[i + k] = v[k];
    }
  }
}

inline unsigned blocks_for(int64_t rows) { return static_cast<unsigned>((rows + WARPS - 1) / WARPS); }

}  // namespace

extern "C" {

// x f32 [n] -> q [rows, 1024], scales f32 [rows]; rows >= ceil(n / 1024).
int tft_quantize_rowwise(const void* x, void* q, void* scales, long long n, long long rows,
                         int kind, void* stream) {
  if (n < 0 || rows <= 0 || rows * ROW < n) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  uint8_t* qp = static_cast<uint8_t*>(q);
  float* sp = static_cast<float*>(scales);
  if (kind == KIND_INT8) {
    quantize_kernel<KIND_INT8><<<blocks_for(rows), THREADS, 0, st>>>(xp, qp, sp, n, rows);
  } else if (kind == KIND_FP8) {
    quantize_kernel<KIND_FP8><<<blocks_for(rows), THREADS, 0, st>>>(xp, qp, sp, n, rows);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// q [>= ceil(n / 1024), 1024], scales f32 [same rows] -> out f32 [n].
int tft_dequantize_rowwise(const void* q, const void* scales, void* out, long long n, int kind,
                           void* stream) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  const int64_t rows = (n + ROW - 1) / ROW;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  if (kind == KIND_INT8) {
    dequantize_kernel<KIND_INT8><<<blocks_for(rows), THREADS, 0, st>>>(qp, sp, op, n, rows);
  } else if (kind == KIND_FP8) {
    dequantize_kernel<KIND_FP8><<<blocks_for(rows), THREADS, 0, st>>>(qp, sp, op, n, rows);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tft_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
