// Causal / full GQA flash-attention forward for Hopper (sm_90a): wgmma
// products, a TMA ring of K/V tiles, the softmax in registers.
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// torchft_tpu/ops/flash_attention.py (launched by _fwd).  It computes what
// that kernel and flash_fwd_plain (torchft_tpu_torch/ops/flash_attention.py)
// compute: o [B, H, Sq, D] bf16 and lse = m + log(l) [B, H, Sq] f32 (natural
// log), scores masked with -1e30 (never -inf, so a fully masked row keeps a
// finite lse), a fully masked row's denominator taken as 1.  q-head h reads
// kv-head h / (H / KV): grouped K/V are never repeated.  Inputs are
// contiguous heads-major bf16: q [B, H, Sq, D], k and v [B, KV, Sk, D].
//
// What bounds it on an H100: causal attention at the Llama-3-8B shapes
// (S = 2048, H = 32, KV = 8, D = 128) does ~800 FLOPs per byte it must move,
// above the ~295 FLOP/byte ridge of bf16, so the bound is the tensor cores'
// rate.  What the design does about it:
// - both products are wgmma (the only path to Hopper's full tensor-core
//   rate): S = Q·K^T with Q and K from shared memory, O += P·V with P from
//   registers and V from shared memory (MN-major, the instruction's
//   transpose-B);
// - S, P and the output accumulator O never leave registers: the row max
//   and row sum reduce over the 4 lanes that share a row of the wgmma
//   accumulator, and S converted to bf16 pairs is P's register fragment;
// - a producer warp keeps the next K/V tile in flight (TMA into a 2-stage
//   ring, "full" barriers counting transaction bytes, "empty" barriers
//   counting the consumers' releases) while two consumer warpgroups compute
//   on the current one; the two warpgroups run unsynchronised, so one's
//   softmax can overlap the other's products;
// - one block owns 128 q-rows, so each K/V byte brought to shared memory
//   feeds 128 rows of products; causally dead k-tiles are never loaded, and
//   the q-tiles with the most k-tiles are scheduled first.
//
// TMA maps are 3-D, (D, S, batch x heads), so a tile reaching past row S of
// one head reads zeros, not the next head's rows; the score mask still
// masks columns >= Sk, since a zero-filled K row scores 0, not -1e30.
//
// tft_flash_fwd_sm90 returns cudaGetLastError() after its launch (0 = ok),
// -1 for a head dim other than 64 or 128, -2 if a tensor map could not be
// encoded, -3 if the driver's cuTensorMapEncodeTiled was not found.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;        // q rows per block: two consumer warpgroups of 64
constexpr int BK = 128;        // keys per k-tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int BOX = 64;        // columns per TMA box: 128 bytes, the swizzle span
constexpr int BOX_BYTES = 128 * BOX * 2;  // one [128 rows][64] box
constexpr int CONSUMERS = 256;            // warps 0-7
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr float NEG_INF = -1e30f;         // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// dynamic shared memory, from a 1024-byte aligned base: Q, the K ring, the
// V ring (each tile [128 rows][D] as D / 64 swizzled boxes), the barriers
template <int D>
struct Smem {
  static constexpr int TILE = D / BOX * BOX_BYTES;
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BARS = V + STAGES * TILE;  // q_full, full[STAGES], empty[STAGES]
  static constexpr int bytes = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
           float* __restrict__ lse, int H, int KV, int Sq, int Sk, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Smem<D>::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // the longest causal rows first: the last q-tiles walk the most k-tiles
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  // causally dead k-tiles (wholly above the diagonal) are never visited
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: one lane issues every load; the ring runs STAGES tiles ahead
    if (threadIdx.x == CONSUMERS) {
      const int qz = b * H + h;
      const int kz = b * KV + h / (H / KV);
      sm90::tma_prefetch(&q_map);
      sm90::tma_prefetch(&k_map);
      sm90::tma_prefetch(&v_map);
      sm90::mbar_arrive_expect_tx(q_full, Smem<D>::TILE);
      for (int c = 0; c < D / BOX; ++c) {
        sm90::tma_load_3d(smem + Smem<D>::Q + c * BOX_BYTES, &q_map, q_full, c * BOX, q0, qz);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        // the consumers released this stage's previous tile (passes at once
        // on the first lap: a fresh barrier has completed no phase)
        sm90::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * Smem<D>::TILE);
        for (int c = 0; c < D / BOX; ++c) {
          sm90::tma_load_3d(smem + Smem<D>::K + s * Smem<D>::TILE + c * BOX_BYTES, &k_map,
                            &full[s], c * BOX, i * BK, kz);
          sm90::tma_load_3d(smem + Smem<D>::V + s * Smem<D>::TILE + c * BOX_BYTES, &v_map,
                            &full[s], c * BOX, i * BK, kz);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); this
  // thread holds rows row0 and row0 + 8, columns 8j + col0 + {0, 1}
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;  // scores are kept in log2 units
  const unsigned char* q_rows = smem + Smem<D>::Q + wg * 64 * 128;  // 64 rows of 128 B per box

  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running row max (log2 units)
  float l[2] = {0.f, 0.f};          // this thread's share of the running row sum

  sm90::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    const unsigned char* k_tile = smem + Smem<D>::K + s * Smem<D>::TILE;
    const unsigned char* v_tile = smem + Smem<D>::V + s * Smem<D>::TILE;
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);

    // S = Q · K^T: both K-major, D / 16 slices of 32 bytes inside 64-column boxes
    float acc_s[BK / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      sm90::wgmma_ss<BK, 0>(acc_s, sm90::desc_sw128(q_rows + off, 16, 1024),
                            sm90::desc_sw128(k_tile + off, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_s);

    // scale and mask; only tiles that cross the diagonal or Sk test each element
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + wg * 64);
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s0 = acc_s[4 * j + e] * scale_log2;
        float s1 = acc_s[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int kcol = k0 + 8 * j + col0 + e;
          if (kcol >= Sk || (causal && kcol > row0)) s0 = NEG_INF;
          if (kcol >= Sk || (causal && kcol > row0 + 8)) s1 = NEG_INF;
        }
        acc_s[4 * j + e] = s0;
        acc_s[4 * j + 2 + e] = s1;
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
    }
    // a row's 128 columns live in the 4 lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float corr0 = exp2f(m[0] - mx0), corr1 = exp2f(m[1] - mx1);
    m[0] = mx0;
    m[1] = mx1;

    // P = exp(S - m); P . V takes P rounded to bf16, the row sum adds it in f32
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i0 = 8 * kk + 2 * r;  // r = 0, 2: row0; r = 1, 3: row0 + 8
        const float mx = (r & 1) ? mx1 : mx0;
        const float a = exp2f(acc_s[i0] - mx), c = exp2f(acc_s[i0 + 1] - mx);
        if (r & 1) {
          sum1 += a + c;
        } else {
          sum0 += a + c;
        }
        __nv_bfloat162 pair = __floats2bfloat162_rn(a, c);
        p[kk][r] = *reinterpret_cast<uint32_t*>(&pair);
      }
    }
    l[0] = l[0] * corr0 + sum0;
    l[1] = l[1] * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc_o[4 * j] *= corr0;
      acc_o[4 * j + 1] *= corr0;
      acc_o[4 * j + 2] *= corr1;
      acc_o[4 * j + 3] *= corr1;
    }

    // O += P · V: V is [keys][D], MN-major for this product; each k16 slice
    // is 16 rows (2048 bytes) down every 64-column box
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      sm90::wgmma_rs<D, 1>(acc_o, p[kk], sm90::desc_sw128(v_tile + kk * 2048, BOX_BYTES, 1024), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_o);
    sm90::mbar_arrive(&empty[s]);  // this thread is done reading the stage
  }

  // epilogue: the quad's partial row sums, normalise, store from registers
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t row_base = ((size_t)b * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = row0 + 8 * r;
    if (qrow >= Sq) continue;
    const float denom = l[r] > 0.f ? l[r] : 1.f;  // fully-masked rows guard
    const float inv = 1.f / denom;
    bf16* dst = o + (row_base + qrow) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc_o[4 * j + 2 * r] * inv, acc_o[4 * j + 2 * r + 1] * inv);
    }
    if (lane % 4 == 0) {
      // m is in log2 units; a row that saw only masked scores keeps -1e30
      lse[row_base + qrow] = m[r] == NEG_INF ? NEG_INF : fmaf(m[r], LN2, logf(denom));
    }
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int KV, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return -3;
  CUtensorMap q_map, k_map, v_map;
  if (!sm90::make_map(encode, &q_map, q, D, Sq, B * H, BQ) ||
      !sm90::make_map(encode, &k_map, k, D, Sk, B * KV, BK) ||
      !sm90::make_map(encode, &v_map, v, D, Sk, B * KV, BK)) {
    return -2;
  }
  const int smem = Smem<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fwd_kernel<D><<<grid, THREADS, smem, stream>>>(q_map, k_map, v_map, static_cast<bf16*>(o),
                                                 static_cast<float*>(lse), H, KV, Sq, Sk, scale,
                                                 causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tft_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int H, int KV, int Sq, int Sk, int D, float scale, int causal,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_fwd<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, s);
    default: return -1;
  }
}

const char* tft_cuda_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim";
    case -2: return "cuTensorMapEncodeTiled refused a tensor map";
    case -3: return "the driver has no cuTensorMapEncodeTiled";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
