// Rowwise int8 / fp8 wire arithmetic shared by the quant kernels
// (csrc/quant.cu: quantize, dequantize; csrc/quant_reduce_sm90.cu: the
// fused reduce).  One row of ROW = 1024 elements is owned by one warp, 32
// values a lane, held as v[STEPS][VEC]; the helpers here do not care which
// element sits in which register, only the callers' loads and stores do.
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

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tftq {

constexpr int ROW = 1024;
constexpr int VEC = 4;                   // consecutive elements per 32-bit word
constexpr int STEPS = ROW / (32 * VEC);  // 8 words of 4 elements per lane
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

// four values divided by the row's safe scale and encoded, v[0] in the
// lowest byte
template <int KIND>
__device__ __forceinline__ uint32_t pack4(const float (&v)[VEC], float safe) {
  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) packed |= encode<KIND>(__fdiv_rn(v[k], safe)) << (8 * k);
  return packed;
}

__device__ __forceinline__ float safe_scale(float scale) { return scale > 0.f ? scale : 1.f; }

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
  const float safe = safe_scale(scale);
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    *reinterpret_cast<uint32_t*>(q_row + s * 128 + lane * VEC) = pack4<KIND>(v[s], safe);
  if (lane == 0) *scale_out = scale;
}

}  // namespace tftq
