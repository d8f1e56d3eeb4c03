// Fused dequant-sum-requant of w quantized contributions for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _reduce_kernel of
// torchft_tpu/ops/pallas_quant.py (launched by _pallas_reduce): qs [w, rows,
// 1024] int8 or e4m3 bytes with scales f32 [w, rows] -> the requantized
// f32 sum Σ_c q_c·s_c, [rows, 1024] bytes and [rows] f32 scales.  It is the
// per-window reduce of the quantized gradient pipeline (w = the replica
// count, 2048 rows per rank per 4 MiB window in the port's Llama-3 run).
//
// What bounds it on an H100: (w + 1)·rows·1028 bytes, each read or written
// once, at 3.35 TB/s, about 3 bytes an element at w = 2.  Bit-identity with
// the host wire makes the arithmetic heavy for so few bytes: an IEEE
// division, a round half to even and a conversion per element and a decode
// per byte, done plainly (reciprocal and conversion units at an eighth of
// the FP32 rate, integer and compare units at half), take longer than the
// bytes.  The design keeps the bytes streaming and moves most of the
// arithmetic onto the FP32 pipes:
// - Blocks of 8 warps; a tile is 8 consecutive rows, warp i owns row
//   r0 + i.  A contribution's tile is one contiguous run of 8·1024 bytes (qs
//   is contiguous and 16-byte aligned, so c·rows·1024 + r0·1024 is a
//   multiple of 16); the last tile is cut to the rows that exist.
// - The grid is as many blocks as fit on the card at once (at most one per
//   tile); block b walks tiles b, b + gridDim.x, ...  Its items, (tile,
//   contribution) in that order, stream through a ring of min(w, 4)
//   shared-memory stages: thread 0 moves each item with one 1-D bulk copy
//   (cp.async.bulk) completed on the stage's "full" mbarrier by transaction
//   bytes, so at w = 2 the next tile is in flight while this one is summed,
//   and no thread holds the payload in registers while it travels.  Each
//   warp releases a stage on its "empty" mbarrier (8 arrivals); thread 0
//   refills it, so any w >= 1 runs through the ring.
// - Scales are not bulk-copied: a bulk copy needs a 16-byte-aligned source
//   and size, and c·rows·4 is neither when rows % 4 != 0.  Lane j of a warp
//   loads its row's scale of contribution j (then j + 32, ...) with a plain
//   load, a tile ahead, and the warp broadcasts it by shuffle.
// - A warp reads its row from shared memory as two 16-byte words a lane
//   (consecutive lanes, consecutive addresses: no bank conflicts; lane l
//   holds elements 512 h + 16 l + [0, 16), h = 0, 1), decodes each byte
//   (add_word: int8 by placing its bits in an f32, e4m3 two at a time by
//   conversion), sums q·s in ascending c onto +0 with __fmul_rn /
//   __fadd_rn, and requantizes by products with the row's reciprocal
//   scale, dividing only where a product lies within two ulps of a
//   rounding boundary (word_by_product).  The payload leaves as two
//   16-byte stores a lane.
//
// The arithmetic is the host wire's, bit for bit (csrc/quant.cuh says what
// that takes); add_word and word_by_product say why their shortcuts give
// the same bits.
//
// tft_reduce_quantized_sm90 returns cudaGetLastError() after its launch
// (0 = ok), or -1 for an unknown wire kind, a bad size or a misaligned
// payload.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"
#include "sm90.cuh"

namespace {

using namespace tftq;
using sm90::bulk_load_1d;
using sm90::mbar_arrive;
using sm90::mbar_arrive_expect_tx;
using sm90::mbar_fence_init;
using sm90::mbar_init;
using sm90::mbar_wait;

constexpr int TILE = 8;  // rows per tile: warp i owns row r0 + i
constexpr int THREADS = TILE * 32;
constexpr int STAGES = 4;  // ring depth when w > 4
constexpr int TILE_BYTES = TILE * ROW;
constexpr int HALF = ROW / 2;  // bytes a warp covers with one 16-byte word a lane

inline size_t smem_bytes(int stages) {
  return static_cast<size_t>(stages) * (TILE_BYTES + 2 * sizeof(uint64_t));
}

// Contribution c's word (4 payload bytes) times s_c, added onto t: each
// product is RN(decode<KIND>(byte) · s_c), as __fmul_rn gives it.  int8
// decodes without a conversion instruction (those run at an eighth of the
// FP32 rate, and the payload has two or more bytes an element): byte k,
// offset by 128, is placed under the exponent of 2^23 (``__byte_perm`` of
// word ^ 0x80808080), and 2^23 + 128 is taken off, exactly the byte's
// value.  e4m3 converts two bytes at a time to f16 (exact) and widens them.
template <int KIND>
__device__ __forceinline__ void add_word(float (&t)[VEC], uint32_t word, float s_c) {
  float x[VEC];
  if (KIND == KIND_INT8) {
    const uint32_t wx = word ^ 0x80808080u;
    x[0] = __fsub_rn(__uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440)), 8388736.f);
    x[1] = __fsub_rn(__uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7441)), 8388736.f);
    x[2] = __fsub_rn(__uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7442)), 8388736.f);
    x[3] = __fsub_rn(__uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7443)), 8388736.f);
  } else {
    const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(word & 0xffffu), __NV_E4M3)));
    const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(word >> 16), __NV_E4M3)));
    x[0] = lo.x;
    x[1] = lo.y;
    x[2] = hi.x;
    x[3] = hi.y;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) t[k] = __fadd_rn(t[k], __fmul_rn(x[k], s_c));
}

// two values as saturating e4m3, x in the low byte
__device__ __forceinline__ uint32_t e4m3x2(float x, float y) {
  return __nv_cvt_float2_to_fp8x2(make_float2(x, y), __NV_SATFINITE, __NV_E4M3);
}

// The payload word of four sums v[0..3] of a row whose scale is 0 or a
// normal number, as pack4<KIND>(v, safe) gives it (the bytes of
// encode<KIND>(__fdiv_rn(v[k], safe))), from products with r = RN(1 / safe),
// r_lo = RN(r · (1 - 2^-21)) and r_hi = RN(r · (1 + 2^-21)).  r's relative
// error is below 2^-24, so the exact v · r is within 2^-24 relative of
// v / safe.  Quotients stay within 127 (448) and a little (|v| <= absmax =
// 127 (448) · safe · (1 + 2^-24)), so no clamp is needed.
// - int8: fma(v, r, 1.5 · 2^23) is 1.5 · 2^23 plus v · r rounded half to
//   even (the sum's ulp is 1), and d = v · r - that integer.  Where
//   |d| <= 0.5 - 2^-15, RN(v / safe) (within 2^-16 of v · r below 128) is
//   on the same side of every half-integer: the integer is its byte.
// - e4m3: v · r_lo and v · r_hi bracket RN(v / safe) (four ulps and more
//   either side) and are converted saturating (for finite values the same
//   as the clip to +-448 then the conversion); rounding is monotonic, so
//   where the two give one byte, that byte is RN(v / safe)'s.
// Elsewhere (near a rounding boundary, about one word in 10^3) ``bad`` is
// set and the caller divides.
template <int KIND>
__device__ __forceinline__ uint32_t word_by_product(const float (&v)[VEC], float r, float r_lo,
                                                    float r_hi, bool& bad) {
  if (KIND == KIND_INT8) {
    uint32_t b[VEC];
    float dmax = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float m = __fmaf_rn(v[k], r, 12582912.f);
      dmax = fmaxf(dmax, fabsf(__fmaf_rn(v[k], r, -__fsub_rn(m, 12582912.f))));
      b[k] = __float_as_uint(m);
    }
    bad |= !(dmax <= 0.5f - 0x1p-15f);
    return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
  } else {
    const uint32_t word = __byte_perm(e4m3x2(__fmul_rn(v[0], r_lo), __fmul_rn(v[1], r_lo)),
                                      e4m3x2(__fmul_rn(v[2], r_lo), __fmul_rn(v[3], r_lo)), 0x5410);
    bad |= word != __byte_perm(e4m3x2(__fmul_rn(v[0], r_hi), __fmul_rn(v[1], r_hi)),
                               e4m3x2(__fmul_rn(v[2], r_hi), __fmul_rn(v[3], r_hi)), 0x5410);
    return word;
  }
}

// this warp's scale of contribution c (0 past the rows or the contributions)
__device__ __forceinline__ float scale_of(const float* __restrict__ scales, int64_t c, int w,
                                          int64_t rows, int64_t row) {
  return (row < rows && c < w) ? __ldg(scales + c * rows + row) : 0.f;
}

// Item j of a block is contribution j % w of its (j / w)-th tile, tile
// blockIdx.x + (j / w) · gridDim.x.  Thread 0 copies it into stage j % stages.
__device__ __forceinline__ void load_item(uint8_t* smem, uint64_t* full, const uint8_t* qs,
                                          int64_t j, int w, int64_t rows, int64_t tiles,
                                          int stages) {
  const int64_t k = j / w;
  const int64_t tile = blockIdx.x + k * gridDim.x;
  if (tile >= tiles) return;
  const int64_t c = j - k * w;
  const int64_t r0 = tile * TILE;
  const uint32_t bytes = static_cast<uint32_t>(rows - r0 < TILE ? rows - r0 : TILE) * ROW;
  const int stage = static_cast<int>(j % stages);
  mbar_arrive_expect_tx(&full[stage], bytes);
  bulk_load_1d(smem + stage * TILE_BYTES, qs + (c * rows + r0) * ROW, bytes, &full[stage]);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 3)
    reduce_sm90_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ scales,
                       uint8_t* __restrict__ q, float* __restrict__ out_scales, int w,
                       int64_t rows, int64_t tiles, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(stages) * TILE_BYTES);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TILE);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < stages; ++j) load_item(smem, full, qs, j, w, rows, tiles, stages);

  // lane l holds this row's scale of contribution 32 i + l for the current
  // run i of 32 contributions; the next tile's first run is loaded a tile ahead
  int64_t tile = blockIdx.x;
  float s_lane = scale_of(scales, lane, w, rows, tile * TILE + warp);
  int64_t j = 0;  // items consumed so far
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t row = tile * TILE + warp;
    const float s_next = scale_of(scales, lane, w, rows, (tile + gridDim.x) * TILE + warp);
    float t[STEPS][VEC];
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[s][k] = 0.f;

    for (int c = 0; c < w; ++c, ++j) {
      if (c > 0 && (c & 31) == 0) s_lane = scale_of(scales, c + lane, w, rows, row);
      const float s_c = __shfl_sync(0xffffffffu, s_lane, c & 31);
      const int stage = static_cast<int>(j % stages);
      const uint32_t parity = static_cast<uint32_t>(j / stages) & 1u;
      mbar_wait(&full[stage], parity);
      const uint8_t* src = smem + stage * TILE_BYTES + warp * ROW + lane * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 p = *reinterpret_cast<const uint4*>(src + h * HALF);
        add_word<KIND>(t[4 * h + 0], p.x, s_c);
        add_word<KIND>(t[4 * h + 1], p.y, s_c);
        add_word<KIND>(t[4 * h + 2], p.z, s_c);
        add_word<KIND>(t[4 * h + 3], p.w, s_c);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (threadIdx.x == 0) {
        mbar_wait(&empty[stage], parity);  // every warp is done with item j
        load_item(smem, full, qs, j + stages, w, rows, tiles, stages);
      }
    }
    s_lane = s_next;
    if (row >= rows) continue;

    // NaN-keeping absmax.  ``probe`` turns NaN at a NaN or an inf; without
    // one, fmaxf is that max, and with one the warp takes nan_max
    float m = 0.f, probe = 0.f;
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        m = fmaxf(m, fabsf(t[s][k]));
        probe = __fmaf_rn(t[s][k], 0.f, probe);
      }
    if (__any_sync(0xffffffffu, probe != probe)) {
      m = 0.f;
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
#pragma unroll
        for (int k = 0; k < VEC; ++k) m = nan_max(m, fabsf(t[s][k]));
    }
    m = warp_absmax(m);
    const float scale = __fdiv_rn(m, KIND == KIND_INT8 ? 127.f : 448.f);
    const float safe = safe_scale(scale);
    uint32_t words[STEPS];
    // the product path needs a normal reciprocal: rows with a NaN, inf or
    // subnormal scale (a warp-uniform branch), and words near a rounding
    // boundary (bit i of ``divide``), divide
    uint32_t divide = 0xffu;
    if (scale == 0.f || (scale >= 0x1p-126f && scale <= 0x1p126f)) {
      const float r = __frcp_rn(safe);
      const float r_lo = __fmul_rn(r, 1.f - 0x1p-21f), r_hi = __fmul_rn(r, 1.f + 0x1p-21f);
      divide = 0;
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        bool bad = false;
        words[i] = word_by_product<KIND>(t[i], r, r_lo, r_hi, bad);
        divide |= static_cast<uint32_t>(bad) << i;
      }
    }
    if (divide) {
#pragma unroll
      for (int i = 0; i < STEPS; ++i)
        if (divide & (1u << i)) words[i] = pack4<KIND>(t[i], safe);
    }
    uint8_t* dst = q + row * ROW + lane * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    *reinterpret_cast<uint4*>(dst + HALF) = make_uint4(words[4], words[5], words[6], words[7]);
    if (lane == 0) out_scales[row] = scale;
  }
}

// Blocks of this kernel that the card holds at once at this ring depth,
// taken once per process from the current device: the grid's size only
// sets how many tiles each block walks, never the result.
template <int KIND>
int resident_blocks(int stages) {
  static int cache[STAGES + 1];
  int& n = cache[stages];
  if (n == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reduce_sm90_kernel<KIND>, THREADS,
                                                  smem_bytes(stages));
    n = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return n;
}

template <int KIND>
int launch(const void* qs, const void* scales, void* q, void* out_scales, int w, int64_t rows,
           cudaStream_t st) {
  const int stages = w < STAGES ? w : STAGES;
  const int64_t tiles = (rows + TILE - 1) / TILE;
  const int64_t resident = resident_blocks<KIND>(stages);
  const unsigned blocks = static_cast<unsigned>(tiles < resident ? tiles : resident);
  reduce_sm90_kernel<KIND><<<blocks, THREADS, smem_bytes(stages), st>>>(
      static_cast<const uint8_t*>(qs), static_cast<const float*>(scales),
      static_cast<uint8_t*>(q), static_cast<float*>(out_scales), w, rows, tiles, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qs [w, rows, 1024], scales f32 [w, rows] -> q [rows, 1024], out_scales f32 [rows].
int tft_reduce_quantized_sm90(const void* qs, const void* scales, void* q, void* out_scales,
                              int w, long long rows, int kind, void* stream) {
  if (w < 1 || rows < 0) return -1;
  if (reinterpret_cast<uintptr_t>(qs) % 16 || reinterpret_cast<uintptr_t>(q) % 16) return -1;
  if (kind != KIND_INT8 && kind != KIND_FP8) return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_INT8 ? launch<KIND_INT8>(qs, scales, q, out_scales, w, rows, st)
                           : launch<KIND_FP8>(qs, scales, q, out_scales, w, rows, st);
}

const char* tft_quant_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
