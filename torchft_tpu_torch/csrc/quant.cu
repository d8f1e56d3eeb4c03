// Rowwise int8 / fp8 quantize, fused reduce and dequantize for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of torchft_tpu/ops/pallas_quant.py:
//   quantize   -> _quant_kernel   (launched by _pallas_quantize)
//   reduce     -> _reduce_kernel  (launched by _pallas_reduce)
//   dequantize -> _dequant_kernel (launched by _pallas_dequant)
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
// Bit-identity with the host wire (torchft_tpu_torch/quantization.py):
//   - products and sums use __fmul_rn / __fadd_rn, so nvcc never contracts
//     them into a fused multiply-add; contributions are summed onto +0 in
//     ascending w, as numpy's sum does (so a sum of -0 products is +0);
//   - scale = absmax / Q and q = x / safe are IEEE divisions (__fdiv_rn),
//     never a multiply by a reciprocal;
//   - int8 rounds half to even (rintf), fp8 converts with saturating
//     round to nearest even after the clip to +-448;
//   - absmax keeps NaN (numpy's max does; fmaxf would drop it), an int8
//     NaN becomes 0 (numpy's cast on x86), an fp8 NaN keeps its sign bit;
//   - an all-zero row gets scale 0 and q 0 (safe = 1).
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok),
// or -1 for an unknown wire kind or a bad size.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 1024;
constexpr int WARPS = 8;  // rows per block: warp i of the block owns one row
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 4;                   // consecutive elements per lane per step
constexpr int STEPS = ROW / (32 * VEC);  // 8: lane l holds [128 s + 4 l, +4) for each step s
constexpr int KIND_INT8 = 0;
constexpr int KIND_FP8 = 1;

__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

__device__ __forceinline__ float warp_absmax(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

template <int KIND>
__device__ __forceinline__ uint32_t encode(float v) {
  if (KIND == KIND_INT8) {
    if (v != v) return 0u;
    v = fminf(fmaxf(rintf(v), -127.f), 127.f);
    return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(v))));
  } else {
    if (v != v) return signbit(v) ? 0xffu : 0x7fu;
    v = fminf(fmaxf(v, -448.f), 448.f);
    return static_cast<uint32_t>(__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
  }
}

template <int KIND>
__device__ __forceinline__ float decode(uint32_t byte) {
  if (KIND == KIND_INT8) {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(byte)));
  } else {
    __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(byte), __NV_E4M3);
    return __half2float(__half(h));
  }
}

// Requantize one row held in registers (v[s][k] is element 128 s + 4 lane + k)
// and store its payload and scale.
template <int KIND>
__device__ __forceinline__ void store_row(float (&v)[STEPS][VEC], uint8_t* __restrict__ q_row,
                                          float* __restrict__ scale_out, int lane) {
  float m = 0.f;
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int k = 0; k < VEC; ++k) m = nan_max(m, fabsf(v[s][k]));
  m = warp_absmax(m);
  const float scale = __fdiv_rn(m, KIND == KIND_INT8 ? 127.f : 448.f);
  const float safe = scale > 0.f ? scale : 1.f;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < VEC; ++k) packed |= encode<KIND>(__fdiv_rn(v[s][k], safe)) << (8 * k);
    *reinterpret_cast<uint32_t*>(q_row + s * 128 + lane * VEC) = packed;
  }
  if (lane == 0) *scale_out = scale;
}

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
    reduce_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ scales,
                  uint8_t* __restrict__ q, float* __restrict__ out_scales, int w, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  float t[STEPS][VEC];
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int k = 0; k < VEC; ++k) t[s][k] = 0.f;
  for (int c = 0; c < w; ++c) {
    const int64_t src = static_cast<int64_t>(c) * rows + row;
    const float s_c = __ldg(scales + src);
    const uint8_t* q_row = qs + src * ROW;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const uint32_t packed = __ldg(reinterpret_cast<const uint32_t*>(q_row + s * 128 + lane * VEC));
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float p = __fmul_rn(decode<KIND>((packed >> (8 * k)) & 0xffu), s_c);
        t[s][k] = __fadd_rn(t[s][k], p);
      }
    }
  }
  store_row<KIND>(t, q + row * ROW, out_scales + row, lane);
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

// qs [w, rows, 1024], scales f32 [w, rows] -> q [rows, 1024], out_scales f32 [rows].
int tft_reduce_quantized(const void* qs, const void* scales, void* q, void* out_scales, int w,
                         long long rows, int kind, void* stream) {
  if (w < 1 || rows < 0) return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qsp = static_cast<const uint8_t*>(qs);
  const float* sp = static_cast<const float*>(scales);
  uint8_t* qp = static_cast<uint8_t*>(q);
  float* op = static_cast<float*>(out_scales);
  if (kind == KIND_INT8) {
    reduce_kernel<KIND_INT8><<<blocks_for(rows), THREADS, 0, st>>>(qsp, sp, qp, op, w, rows);
  } else if (kind == KIND_FP8) {
    reduce_kernel<KIND_FP8><<<blocks_for(rows), THREADS, 0, st>>>(qsp, sp, qp, op, w, rows);
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
