// Causal / full GQA flash attention for Hopper (sm_90a): forward, dq, dkv.
//
// Replaces the three Pallas TPU kernels of torchft_tpu/ops/flash_attention.py:
//   fwd  -> _fwd_kernel (launched by _fwd)
//   dq   -> _dq_kernel  (first pallas_call of _bwd)
//   dkv  -> _dkv_kernel (second pallas_call of _bwd)
//
// Layout: heads-major and contiguous.  q, o, do, dq are [B, H, Sq, D]; k, v,
// dk, dv are [B, KV, Sk, D]; lse and delta are [B, H, Sq] f32.  q-head h
// reads kv-head h / (H / KV), so grouped K/V are never repeated.  Inputs are
// bf16; scores, softmax statistics and every accumulator are f32.
//
// What bounds them on an H100: causal GQA attention at the Llama-3-8B
// shapes (S=2048, H=32, KV=8, D=128) does ~800 FLOPs per byte it must move,
// well above the ~295 FLOP/byte ridge of bf16, so the bound is operations:
// the tensor cores' rate.  What the design does about it: one thread block
// owns a 64-row tile and walks the other operand's 64-row tiles, so the
// [S, S] score matrix never reaches device memory and every byte loaded to
// shared memory feeds 64 rows of products; causally dead tiles are skipped.
// This first version reaches a fraction of the bound: its products run as
// bf16 wmma 16x16x16 fragments (not wgmma), loads are synchronous (no TMA
// pipeline), and the score, probability and accumulator tiles round-trip
// through shared memory between the products and the row-wise softmax.
//
// Grid mapping (the TPU's sequential grid axes become in-block loops):
//   fwd, dq: one block per (q-tile, q-head, batch), looping over k-tiles.
//   dkv:     one block per (k-tile, kv-head, batch), looping over every
//            q-head of the GQA group x every q-tile, so the group sum stays
//            inside the block with no atomics.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok),
// or -1 for a head dim this file was not instantiated for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // k rows per tile
constexpr int NWARPS = 4;  // warp w owns rows [16w, 16w + 16) of a tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

// padded leading dims (elements) keep wmma pointers 32-byte aligned and
// spread rows over shared-memory banks
template <int D>
struct Ld {
  static constexpr int X = D + 8;    // bf16 operand tiles [rows][D]
  static constexpr int ACC = D + 4;  // f32 accumulators [rows][D]
};
constexpr int LD_S = BK + 4;  // f32 score tiles [BQ][BK]
constexpr int LD_P = BK + 8;  // bf16 probability tiles [BQ][BK]

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + 64) of a contiguous [nrows, D] bf16 matrix into a
// padded shared tile; rows past the end are zero-filled
template <int D>
__device__ void load_tile(bf16* dst, const bf16* src, int row0, int nrows) {
  constexpr int VEC = 8;  // bf16 per 16-byte load
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Ld<D>::X + c) = val;
  }
}

// rows [row0, row0 + 64) of a [nrows] f32 vector; rows past the end read 0
__device__ void load_rows(float* dst, const float* src, int row0, int nrows) {
  for (int r = threadIdx.x; r < 64; r += NTHREADS) {
    dst[r] = row0 + r < nrows ? src[row0 + r] : 0.f;
  }
}

__device__ void zero_f32(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) dst[i] = 0.f;
}

// out[16w + i][j] = sum_d A[16w + i][d] * B[j][d] for j < 64: the warp's
// 16-row strip of A . B^T, with A and B padded [64][D] bf16 tiles
template <int D>
__device__ void warp_abT(float* out, const bf16* A, const bf16* B, int warp) {
  AccFrag acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + warp * 16 * Ld<D>::X + kk, Ld<D>::X);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // B^T as a col-major operand: element (k, n) sits at B[n][k]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, B + j * 16 * Ld<D>::X + kk, Ld<D>::X);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(out + warp * 16 * LD_S + j * 16, acc[j], LD_S,
                            wmma::mem_row_major);
  }
}

// C[16w + i][0..D) += sum_k A(16w + i, k) * B[k][0..D) over k < 64, where
// A is a bf16 [64][64] tile read row-major (A(m, k) = P[m][k]) or, with
// TRANSPOSE_A, column-major (A(m, k) = P[k][m]); B is a padded [64][D] tile
// and C a padded f32 [64][D] accumulator in shared memory
template <int D, bool TRANSPOSE_A>
__device__ void warp_acc(float* C, const bf16* P, const bf16* B, int warp) {
  typedef typename std::conditional<TRANSPOSE_A, wmma::col_major, wmma::row_major>::type LayoutA;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* src = TRANSPOSE_A ? P + kk * 16 * LD_P + warp * 16
                                  : P + warp * 16 * LD_P + kk * 16;
    wmma::load_matrix_sync(a[kk], src, LD_P);
  }
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    AccFrag acc;
    float* dst = C + warp * 16 * Ld<D>::ACC + j * 16;
    wmma::load_matrix_sync(acc, dst, Ld<D>::ACC, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + kk * 16 * Ld<D>::X + j * 16, Ld<D>::X);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(dst, acc, Ld<D>::ACC, wmma::mem_row_major);
  }
}

// masked, scaled score of tile element (r, c); a dead element is NEG_INF
__device__ __forceinline__ float masked_score(float s, float scale, int qrow, int kcol,
                                              int Sk, bool causal) {
  return (kcol >= Sk || (causal && kcol > qrow)) ? NEG_INF : s * scale;
}

template <int D>
struct FwdSmem {
  static constexpr size_t bytes = 3 * 64 * Ld<D>::X * sizeof(bf16)  // q, k, v
                                  + 64 * LD_S * sizeof(float)        // scores
                                  + 64 * LD_P * sizeof(bf16)         // probabilities
                                  + 64 * Ld<D>::ACC * sizeof(float)  // output acc
                                  + 2 * 64 * sizeof(float);          // m, l
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
           int H, int KV, int Sq, int Sk, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + 64 * Ld<D>::X;
  bf16* v_s = k_s + 64 * Ld<D>::X;
  float* s_s = reinterpret_cast<float*>(v_s + 64 * Ld<D>::X);
  bf16* p_s = reinterpret_cast<bf16*>(s_s + 64 * LD_S);
  float* o_s = reinterpret_cast<float*>(p_s + 64 * LD_P);
  float* m_s = o_s + 64 * Ld<D>::ACC;
  float* l_s = m_s + 64;

  // the longest causal rows first: the last q-tiles walk the most k-tiles
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const size_t koff = ((size_t)b * KV + kvh) * Sk;

  load_tile<D>(q_s, q + qoff * D, q0, Sq);
  zero_f32(o_s, 64 * Ld<D>::ACC);
  for (int r = threadIdx.x; r < 64; r += NTHREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  // causally dead k-tiles (wholly above the diagonal) are never visited
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile's readers are done with k_s / v_s
    load_tile<D>(k_s, k + koff * D, k0, Sk);
    load_tile<D>(v_s, v + koff * D, k0, Sk);
    __syncthreads();
    warp_abT<D>(s_s, q_s, k_s, warp);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qrow = q0 + r;
      const float s0 = masked_score(s_s[r * LD_S + lane], scale, qrow, k0 + lane, Sk, causal);
      const float s1 =
          masked_score(s_s[r * LD_S + lane + 32], scale, qrow, k0 + lane + 32, Sk, causal);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float row_sum = warp_sum(p0 + p1);
      const float corr = expf(m_prev - m_new);
      // p . V takes p rounded to bf16; the denominator sums it in f32
      p_s[r * LD_P + lane] = __float2bfloat16(p0);
      p_s[r * LD_P + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < D; c += 32) o_s[r * Ld<D>::ACC + c] *= corr;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + row_sum;
      }
    }
    __syncwarp();
    warp_acc<D, false>(o_s, p_s, v_s, warp);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int qrow = q0 + r;
    if (qrow >= Sq) break;
    const float l = l_s[r];
    const float denom = l > 0.f ? l : 1.f;  // fully-masked rows guard
    const float inv = 1.f / denom;
    bf16* dst = o + (qoff + qrow) * D;
    for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(o_s[r * Ld<D>::ACC + c] * inv);
    if (lane == 0) lse[qoff + qrow] = m_s[r] + logf(denom);
  }
}

template <int D>
struct DqSmem {
  static constexpr size_t bytes = 4 * 64 * Ld<D>::X * sizeof(bf16)  // q, do, k, v
                                  + 2 * 64 * LD_S * sizeof(float)    // s, dp
                                  + 64 * LD_P * sizeof(bf16)         // ds
                                  + 64 * Ld<D>::ACC * sizeof(float)  // dq acc
                                  + 2 * 64 * sizeof(float);          // lse, delta
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const float* __restrict__ lse, const bf16* __restrict__ dout,
          const float* __restrict__ delta, bf16* __restrict__ dq, int H, int KV, int Sq,
          int Sk, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + 64 * Ld<D>::X;
  bf16* k_s = do_s + 64 * Ld<D>::X;
  bf16* v_s = k_s + 64 * Ld<D>::X;
  float* s_s = reinterpret_cast<float*>(v_s + 64 * Ld<D>::X);
  float* dp_s = s_s + 64 * LD_S;
  bf16* ds_s = reinterpret_cast<bf16*>(dp_s + 64 * LD_S);
  float* dq_s = reinterpret_cast<float*>(ds_s + 64 * LD_P);
  float* lse_s = dq_s + 64 * Ld<D>::ACC;
  float* delta_s = lse_s + 64;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const size_t koff = ((size_t)b * KV + kvh) * Sk;

  load_tile<D>(q_s, q + qoff * D, q0, Sq);
  load_tile<D>(do_s, dout + qoff * D, q0, Sq);
  load_rows(lse_s, lse + qoff, q0, Sq);
  load_rows(delta_s, delta + qoff, q0, Sq);
  zero_f32(dq_s, 64 * Ld<D>::ACC);
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<D>(k_s, k + koff * D, k0, Sk);
    load_tile<D>(v_s, v + koff * D, k0, Sk);
    __syncthreads();
    warp_abT<D>(s_s, q_s, k_s, warp);
    warp_abT<D>(dp_s, do_s, v_s, warp);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qrow = q0 + r;
      const bool row_ok = qrow < Sq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float s = masked_score(s_s[r * LD_S + c], scale, qrow, k0 + c, Sk, causal);
        const float p = row_ok ? expf(s - lse_s[r]) : 0.f;
        const float ds = p * (dp_s[r * LD_S + c] - delta_s[r]) * scale;
        ds_s[r * LD_P + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    warp_acc<D, false>(dq_s, ds_s, k_s, warp);  // dq += ds . k
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int qrow = q0 + r;
    if (qrow >= Sq) break;
    bf16* dst = dq + (qoff + qrow) * D;
    for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(dq_s[r * Ld<D>::ACC + c]);
  }
}

template <int D>
struct DkvSmem {
  static constexpr size_t bytes = 4 * 64 * Ld<D>::X * sizeof(bf16)      // k, v, q, do
                                  + 2 * 64 * LD_S * sizeof(float)        // s, dp
                                  + 2 * 64 * LD_P * sizeof(bf16)         // p, ds
                                  + 2 * 64 * Ld<D>::ACC * sizeof(float)  // dk, dv acc
                                  + 2 * 64 * sizeof(float);              // lse, delta
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const float* __restrict__ lse, const bf16* __restrict__ dout,
           const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
           int H, int KV, int Sq, int Sk, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + 64 * Ld<D>::X;
  bf16* q_s = v_s + 64 * Ld<D>::X;
  bf16* do_s = q_s + 64 * Ld<D>::X;
  float* s_s = reinterpret_cast<float*>(do_s + 64 * Ld<D>::X);
  float* dp_s = s_s + 64 * LD_S;
  bf16* p_s = reinterpret_cast<bf16*>(dp_s + 64 * LD_S);
  bf16* ds_s = p_s + 64 * LD_P;
  float* dk_s = reinterpret_cast<float*>(ds_s + 64 * LD_P);
  float* dv_s = dk_s + 64 * Ld<D>::ACC;
  float* lse_s = dv_s + 64 * Ld<D>::ACC;
  float* delta_s = lse_s + 64;

  // causal: the first k-tiles are reached by the most q-tiles
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int groups = H / KV;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t koff = ((size_t)b * KV + kvh) * Sk;

  load_tile<D>(k_s, k + koff * D, k0, Sk);
  load_tile<D>(v_s, v + koff * D, k0, Sk);
  zero_f32(dk_s, 64 * Ld<D>::ACC);
  zero_f32(dv_s, 64 * Ld<D>::ACC);
  // q-tiles wholly above the diagonal see none of this k-tile
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    const size_t qoff = ((size_t)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
      __syncthreads();  // previous iteration's readers are done
      load_tile<D>(q_s, q + qoff * D, q0, Sq);
      load_tile<D>(do_s, dout + qoff * D, q0, Sq);
      load_rows(lse_s, lse + qoff, q0, Sq);
      load_rows(delta_s, delta + qoff, q0, Sq);
      __syncthreads();
      warp_abT<D>(s_s, q_s, k_s, warp);    // rows: this warp's q rows
      warp_abT<D>(dp_s, do_s, v_s, warp);
      __syncwarp();
      for (int rr = 0; rr < 16; ++rr) {
        const int r = warp * 16 + rr;
        const int qrow = q0 + r;
        const bool row_ok = qrow < Sq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const float s = masked_score(s_s[r * LD_S + c], scale, qrow, k0 + c, Sk, causal);
          const float p = row_ok ? expf(s - lse_s[r]) : 0.f;
          const float ds = p * (dp_s[r * LD_S + c] - delta_s[r]) * scale;
          p_s[r * LD_P + c] = __float2bfloat16(p);
          ds_s[r * LD_P + c] = __float2bfloat16(ds);
        }
      }
      __syncthreads();  // every q row of p / ds feeds every k row below
      warp_acc<D, true>(dv_s, p_s, do_s, warp);  // dv += p^T . do
      warp_acc<D, true>(dk_s, ds_s, q_s, warp);  // dk += ds^T . q
    }
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int krow = k0 + r;
    if (krow >= Sk) break;
    bf16* dk_dst = dk + (koff + krow) * D;
    bf16* dv_dst = dv + (koff + krow) * D;
    for (int c = lane; c < D; c += 32) {
      dk_dst[c] = __float2bfloat16(dk_s[r * Ld<D>::ACC + c]);
      dv_dst[c] = __float2bfloat16(dv_s[r * Ld<D>::ACC + c]);
    }
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int KV, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  const int smem = (int)FwdSmem<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, KV, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* lse, const void* dout,
              const void* delta, void* dq, int B, int H, int KV, int Sq, int Sk, float scale,
              int causal, cudaStream_t stream) {
  const int smem = (int)DqSmem<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(lse), static_cast<const bf16*>(dout),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, KV, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* lse, const void* dout,
               const void* delta, void* dk, void* dv, int B, int H, int KV, int Sq, int Sk,
               float scale, int causal, cudaStream_t stream) {
  const int smem = (int)DkvSmem<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + BK - 1) / BK, KV, B);
  dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(lse), static_cast<const bf16*>(dout),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KV,
      Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tft_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                  int KV, int Sq, int Sk, int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_fwd<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, s);
    default: return -1;
  }
}

int tft_flash_dq(const void* q, const void* k, const void* v, const void* lse, const void* dout,
                 const void* delta, void* dq, int B, int H, int KV, int Sq, int Sk, int D,
                 float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, lse, dout, delta, dq, B, H, KV, Sq, Sk, scale, causal, s);
    case 128:
      return launch_dq<128>(q, k, v, lse, dout, delta, dq, B, H, KV, Sq, Sk, scale, causal, s);
    default: return -1;
  }
}

int tft_flash_dkv(const void* q, const void* k, const void* v, const void* lse,
                  const void* dout, const void* delta, void* dk, void* dv, int B, int H, int KV,
                  int Sq, int Sk, int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, lse, dout, delta, dk, dv, B, H, KV, Sq, Sk, scale, causal,
                            s);
    case 128:
      return launch_dkv<128>(q, k, v, lse, dout, delta, dk, dv, B, H, KV, Sq, Sk, scale, causal,
                             s);
    default: return -1;
  }
}

const char* tft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
