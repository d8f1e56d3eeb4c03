// Causal / full GQA flash-attention dK/dV for Hopper (sm_90a): wgmma on
// transposed scores, a TMA ring of Q/dO tiles, dK and dV in registers, a
// deterministic sum over the GQA group.
//
// Replaces the Pallas TPU kernel _dkv_kernel of
// torchft_tpu/ops/flash_attention.py (the second pallas_call of _bwd).  It
// computes what that kernel and flash_dkv_plain
// (torchft_tpu_torch/ops/flash_attention.py) compute: dk and dv
// [B, KV, Sk, D] bf16 from q and do [B, H, Sq, D], k and v [B, KV, Sk, D]
// (bf16) and lse and delta [B, H, Sq] (f32), with p = exp(s·scale − lse)
// (masked scores are −1e30, never −inf), ds = p·(dp − delta)·scale in f32,
// P and dS rounded to bf16 before their products and every accumulator f32.
// kv-head kvh sums its whole GQA group, q-heads kvh·G … kvh·G + G − 1
// (G = H / KV).
//
// What bounds it on an H100: at the Llama-3-8B shapes (S = 2048, H = 32,
// KV = 8, D = 128, causal) it does 68.7 GFLOP on 42 MB, far above the ~295
// FLOP/byte ridge of bf16, so the bound is the tensor cores' rate.  What the
// design does about it:
// - transposed scores, so that nothing is transposed: S^T = K·Q^T and
//   dP^T = V·dO^T are wgmma SS with keys as rows (K or V from shared memory
//   as A, the Q or dO tile as B, both K-major).  Their m64nBQ accumulators,
//   turned into P^T and dS^T in place and packed into bf16 pairs, are the
//   register A fragments of dV += P^T·dO and dK += dS^T·Q, wgmma RS that
//   read the same dO and Q tiles MN-major (the transpose-B descriptor).  No
//   tile is transposed in shared memory and no accumulator lives there;
// - one block owns 128 keys, two warpgroups of 64; its K and V tiles arrive
//   once by TMA and stay resident, and dK and dV stay in registers (64 + 64
//   f32 a thread at D = 128) until the epilogue.  With S^T and dP^T beside
//   them (BQ / 2 f32 each) a thread needs more than the 168 registers a
//   block with a producer warp beside its two warpgroups could give it
//   (ptxas then spills and runs the wgmma one at a time), so the block is
//   the two warpgroups alone, and each thread may take 255;
// - warp 0 also loads: it streams Q and dO tiles of BQ rows by TMA through
//   a STAGES-deep ring ("full" barriers counting transaction bytes and the
//   arrivals of warp 0's lanes, "empty" barriers counting the releases of
//   all 256 threads), refilling a stage once every thread is done with it,
//   with the tile's lse and delta rows beside them in shared memory (plain
//   loads: a [B·H, Sq] f32 tensor map would need Sq·4 to be a multiple of
//   16 bytes);
// - only q-tiles that reach the block's keys are visited: under the causal
//   mask the first is q0 = k0, and warpgroup 1 skips its products on the
//   tiles whose queries all precede its keys;
// - the GQA group sum.  There is one block per (k-tile, q-head, batch).  For
//   G > 1 each writes its f32 dK/dV partial to a scratch buffer, and the
//   block that arrives last on its (batch, kv-head, k-tile) counter sums the
//   G partials in the fixed order g = 0 … G − 1, its own from registers at
//   its own place, and writes bf16 (the threadFenceReduction pattern).  No
//   block waits on another, there are no floating-point atomics, and the
//   result does not depend on the order of arrival: two launches give
//   bit-identical dk and dv.  For G = 1 the block writes bf16 directly;
// - the grid is 1-D with the k-tile slowest, so under the causal mask the
//   k-tiles with the most q-tiles start first.
//
// TMA maps are 3-D, (D, S, batch x heads): a Q or dO tile past row Sq of one
// head reads zeros, and its rows are masked (p = 0) since their lse is not
// defined; keys past Sk are masked too and never stored.
//
// tft_flash_dkv_sm90 returns cudaGetLastError() after its launch (0 = ok),
// -1 for a head dim other than 64 or 128, -2 if a tensor map could not be
// encoded, -3 if the driver's cuTensorMapEncodeTiled was not found, -4 if
// G > 1 and the scratch or its counters are missing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BK = 128;   // keys per block: two consumer warpgroups of 64
constexpr int BQ = 64;    // q rows per ring tile
constexpr int STAGES = 2;  // Q/dO ring depth
constexpr int BOX = 64;   // columns per TMA box: 128 bytes, the swizzle span
constexpr int K_BOX_BYTES = BK * BOX * 2;  // one [128 keys][64] box
constexpr int Q_BOX_BYTES = BQ * BOX * 2;  // one [BQ q rows][64] box
// two warpgroups and nothing else: a block of 9 or 12 warps puts 3 warps on
// one of the SM's 4 register-file quarters (16,384 registers each), which
// caps every thread at 168 registers; 8 warps may take 255
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;          // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

// dynamic shared memory, from a 1024-byte aligned base: K and V (each
// [128 keys][D] as D / 64 swizzled boxes), the Q and dO rings (each tile
// [BQ rows][D]), each stage's lse and delta rows, the barriers and the
// "last block" flag
template <int D>
struct Smem {
  static constexpr int K_TILE = D / BOX * K_BOX_BYTES;
  static constexpr int Q_TILE = D / BOX * Q_BOX_BYTES;
  static constexpr int K = 0;
  static constexpr int V = K + K_TILE;
  static constexpr int Q = V + K_TILE;
  static constexpr int DO = Q + STAGES * Q_TILE;
  static constexpr int ROWS = DO + STAGES * Q_TILE;             // [STAGES][lse BQ, delta BQ] f32
  static constexpr int BARS = ROWS + STAGES * 2 * BQ * 4;       // kv_full, full[], empty[]
  static constexpr int FLAG = BARS + 8 * (1 + 2 * STAGES);
  static constexpr int bytes = FLAG + 16 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ partial,
           int* __restrict__ counters, int H, int KV, int Sq, int Sk, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  float* rows = reinterpret_cast<float*>(smem + Smem<D>::ROWS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Smem<D>::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  int* last_flag = reinterpret_cast<int*>(smem + Smem<D>::FLAG);

  // 1-D grid, k-tile slowest, then (batch, kv-head), then the q-head within
  // the group: under the causal mask the first k-tiles have the most q-tiles
  const int G = H / KV;
  const int n_kt = (Sk + BK - 1) / BK;
  const int units = gridDim.x / n_kt;  // B · KV · G
  const int kt = blockIdx.x / units;
  const int g = blockIdx.x % units % G;    // this block's place in the group
  const int bkv = blockIdx.x % units / G;  // b · KV + kvh
  const int b = bkv / KV;
  const int k0 = kt * BK;
  const int qz = b * H + (bkv % KV) * G + g;  // the block's (batch, q-head)
  // q-tiles wholly before the block's first key see none of it
  const int qt0 = causal ? k0 / BQ : 0;
  const int n_iter = (Sq + BQ - 1) / BQ - qt0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);  // lane 0's expect_tx + every lane of warp 0's rows
      sm90::mbar_init(&empty[s], THREADS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // warp 0 loads, besides its share of the products: lane 0 issues the TMA
  // copies of q-tile i into stage i % STAGES, and every lane copies its
  // share of the tile's lse and delta rows (rows past Sq read 0, and their
  // p is masked to 0); the ring runs STAGES tiles ahead
  const int lane = threadIdx.x % 32;
  auto load = [&](int i) {
    const int s = i % STAGES;
    const int q0 = (qt0 + i) * BQ;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&full[s], 2 * Smem<D>::Q_TILE);
      for (int c = 0; c < D / BOX; ++c) {
        sm90::tma_load_3d(smem + Smem<D>::Q + s * Smem<D>::Q_TILE + c * Q_BOX_BYTES, &q_map,
                          &full[s], c * BOX, q0, qz);
        sm90::tma_load_3d(smem + Smem<D>::DO + s * Smem<D>::Q_TILE + c * Q_BOX_BYTES, &do_map,
                          &full[s], c * BOX, q0, qz);
      }
    }
    float* dst = rows + s * 2 * BQ;
    const float* lse_row = lse + (size_t)qz * Sq;
    const float* delta_row = delta + (size_t)qz * Sq;
    for (int t = lane; t < BQ; t += 32) {
      const bool ok = q0 + t < Sq;
      dst[t] = ok ? lse_row[q0 + t] : 0.f;
      dst[BQ + t] = ok ? delta_row[q0 + t] : 0.f;
    }
    sm90::mbar_arrive(&full[s]);  // release: the rows are visible to the waiters
  };
  if (threadIdx.x < 32) {
    if (lane == 0) {
      sm90::tma_prefetch(&q_map);
      sm90::tma_prefetch(&do_map);
      sm90::mbar_arrive_expect_tx(kv_full, 2 * Smem<D>::K_TILE);
      for (int c = 0; c < D / BOX; ++c) {
        sm90::tma_load_3d(smem + Smem<D>::K + c * K_BOX_BYTES, &k_map, kv_full, c * BOX, k0, bkv);
        sm90::tma_load_3d(smem + Smem<D>::V + c * K_BOX_BYTES, &v_map, kv_full, c * BOX, k0, bkv);
      }
    }
    for (int i = 0; i < STAGES && i < n_iter; ++i) load(i);
  }

  // consumers: warpgroup wg owns keys [kb, kb + 64), kb = k0 + 64 wg; this
  // thread holds keys key0 and key0 + 8 (accumulator rows), q columns
  // 8j + col0 + {0, 1} of S^T and dP^T, and D columns 8j + col0 + {0, 1} of
  // dK and dV
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int kb = k0 + wg * 64;
  const int key0 = kb + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;  // scores are kept in log2 units
  // operand descriptors at the start of this warpgroup's 64 K and V rows
  // (64 rows of 128 B in each box) and of stage 0's Q and dO tiles, K-major
  // for S^T and dP^T, MN-major for dV and dK (LBO: the next 64-column box)
  const uint64_t k_desc = sm90::desc_sw128(smem + Smem<D>::K + wg * 64 * 128, 16, 1024);
  const uint64_t v_desc = sm90::desc_sw128(smem + Smem<D>::V + wg * 64 * 128, 16, 1024);
  const uint64_t q_desc = sm90::desc_sw128(smem + Smem<D>::Q, 16, 1024);
  const uint64_t do_desc = sm90::desc_sw128(smem + Smem<D>::DO, 16, 1024);
  const uint64_t q_desc_mn = sm90::desc_sw128(smem + Smem<D>::Q, Q_BOX_BYTES, 1024);
  const uint64_t do_desc_mn = sm90::desc_sw128(smem + Smem<D>::DO, Q_BOX_BYTES, 1024);

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }

  sm90::mbar_wait(kv_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % STAGES;
    const int q0 = (qt0 + i) * BQ;
    const uint32_t stage = s * Smem<D>::Q_TILE;
    const float* lse_s = rows + s * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);

    // a tile whose queries all precede this warpgroup's keys adds nothing
    if (!(causal && q0 + BQ <= kb)) {
      // S^T = K · Q^T, then dP^T = V · dO^T: all K-major, D / 16 slices of
      // 32 bytes inside 64-column boxes; two groups, so that p can be
      // computed while dP^T is in flight
      float acc_s[BQ / 2], acc_dp[BQ / 2];
      const uint64_t kd = sm90::opaque(k_desc), qd = sm90::opaque(q_desc) + (stage >> 4);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ka = (kk / 4) * K_BOX_BYTES + (kk % 4) * 32;
        const int qa = (kk / 4) * Q_BOX_BYTES + (kk % 4) * 32;
        sm90::wgmma_ss<BQ, 0>(acc_s, sm90::desc_add(kd, ka), sm90::desc_add(qd, qa), kk > 0);
      }
      sm90::wgmma_commit();
      const uint64_t vd = sm90::opaque(v_desc), dod = sm90::opaque(do_desc) + (stage >> 4);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ka = (kk / 4) * K_BOX_BYTES + (kk % 4) * 32;
        const int qa = (kk / 4) * Q_BOX_BYTES + (kk % 4) * 32;
        sm90::wgmma_ss<BQ, 0>(acc_dp, sm90::desc_add(vd, ka), sm90::desc_add(dod, qa), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(acc_s);

      // P^T = exp(S^T·scale − lse) in place; element 4j + 2r + e is key
      // key0 + 8r, query q0 + 8j + col0 + e.  Only tiles that cross the
      // diagonal, Sq or Sk test each element.
      const bool edge = (causal && q0 < kb + 64) || q0 + BQ > Sq || kb + 64 > Sk;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + col0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lse_log2 = (e ? l2.y : l2.x) * LOG2E;
          const int qc = q0 + 8 * j + col0 + e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 4 * j + 2 * r + e;
            float sl = acc_s[idx] * scale_log2;
            bool dead = false;
            if (edge) {
              const int kr = key0 + 8 * r;
              // a masked score is the reference's -1e30 before the exp
              if (causal && qc < kr) sl = NEG_INF * LOG2E;
              dead = qc >= Sq || kr >= Sk;
            }
            acc_s[idx] = dead ? 0.f : exp2f(sl - lse_log2);
          }
        }
      }

      // dS^T = P^T · (dP^T − delta) · scale; P^T and dS^T packed in bf16
      // pairs: registers 8kk .. 8kk + 7 are the A fragment of k16 slice kk
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_dp);
      uint32_t p_frag[BQ / 16][4], ds_frag[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i0 = 8 * kk + 2 * rr;  // columns 8(2kk + rr/2) + col0 + {0, 1}
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * (2 * kk + rr / 2) + col0);
          const float p0 = acc_s[i0], p1 = acc_s[i0 + 1];
          const float ds0 = p0 * (acc_dp[i0] - d2.x) * scale;
          const float ds1 = p1 * (acc_dp[i0 + 1] - d2.y) * scale;
          __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
          __nv_bfloat162 dd = __floats2bfloat162_rn(ds0, ds1);
          p_frag[kk][rr] = *reinterpret_cast<uint32_t*>(&pp);
          ds_frag[kk][rr] = *reinterpret_cast<uint32_t*>(&dd);
        }
      }

      // dV += P^T · dO and dK += dS^T · Q: dO and Q are [q rows][D],
      // MN-major for these products; each k16 slice is 16 rows (2048
      // bytes) down every 64-column box
      const uint64_t dom = sm90::opaque(do_desc_mn) + (stage >> 4);
      const uint64_t qm = sm90::opaque(q_desc_mn) + (stage >> 4);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::wgmma_rs<D, 1>(acc_dv, p_frag[kk], sm90::desc_add(dom, kk * 2048), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::wgmma_rs<D, 1>(acc_dk, ds_frag[kk], sm90::desc_add(qm, kk * 2048), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_dv);
      sm90::fence_regs(acc_dk);
    }
    sm90::mbar_arrive(&empty[s]);  // every thread releases every stage
    if (threadIdx.x < 32 && i + STAGES < n_iter) {
      sm90::mbar_wait(&empty[s], (i / STAGES) & 1);  // every thread is done with tile i
      load(i + STAGES);
    }
  }

  const size_t kv_row = (size_t)bkv * Sk;  // row 0 of dk/dv for (b, kvh)
  if (G == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= Sk) continue;
      bf16* dk_dst = dk + (kv_row + key) * D + col0;
      bf16* dv_dst = dv + (kv_row + key) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk_dst + 8 * j) =
            __floats2bfloat162_rn(acc_dk[4 * j + 2 * r], acc_dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_dst + 8 * j) =
            __floats2bfloat162_rn(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
      }
    }
    return;
  }

  // this q-head's f32 partials: partial dk [B·KV·G][Sk][D], then partial dv
  const size_t part_dv = (size_t)units * Sk * D;
  const size_t group_row = (size_t)bkv * G * Sk;  // row 0 of the group's first q-head
  float* own = partial + (group_row + (size_t)g * Sk) * D + col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (size_t)key * D + 8 * j;
      *reinterpret_cast<float2*>(own + at) =
          make_float2(acc_dk[4 * j + 2 * r], acc_dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(own + part_dv + at) =
          make_float2(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
    }
  }
  // the last block of the group to get here sums it
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *last_flag = atomicAdd(&counters[bkv * n_kt + kt], 1) == G - 1;
  }
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();

  const float* first = partial + group_row * D + col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    bf16* dk_dst = dk + (kv_row + key) * D + col0;
    bf16* dv_dst = dv + (kv_row + key) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
      // g = 0 … G − 1 in order, whichever block sums; L2 reads (__ldcg):
      // L1 is not coherent across blocks
      for (int m = 0; m < G; ++m) {
        float2 pk, pv;
        if (m == g) {
          pk = make_float2(acc_dk[4 * j + 2 * r], acc_dk[4 * j + 2 * r + 1]);
          pv = make_float2(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
        } else {
          const size_t at = ((size_t)m * Sk + key) * D + 8 * j;
          pk = __ldcg(reinterpret_cast<const float2*>(first + at));
          pv = __ldcg(reinterpret_cast<const float2*>(first + part_dv + at));
        }
        sk.x += pk.x;
        sk.y += pk.y;
        sv.x += pv.x;
        sv.y += pv.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(dk_dst + 8 * j) = __floats2bfloat162_rn(sk.x, sk.y);
      *reinterpret_cast<__nv_bfloat162*>(dv_dst + 8 * j) = __floats2bfloat162_rn(sv.x, sv.y);
    }
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* lse, const void* dout,
               const void* delta, void* dk, void* dv, void* partial, void* counters, int B,
               int H, int KV, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  if (B == 0 || KV == 0 || Sk == 0) return 0;
  if (H > KV && (partial == nullptr || counters == nullptr)) return -4;
  const size_t out_bytes = (size_t)B * KV * Sk * D * 2;
  if (Sq == 0) {  // no query: the gradients are 0
    cudaError_t err = cudaMemsetAsync(dk, 0, out_bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, out_bytes, stream);
    return (int)err;
  }
  sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return -3;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!sm90::make_map(encode, &q_map, q, D, Sq, B * H, BQ) ||
      !sm90::make_map(encode, &do_map, dout, D, Sq, B * H, BQ) ||
      !sm90::make_map(encode, &k_map, k, D, Sk, B * KV, BK) ||
      !sm90::make_map(encode, &v_map, v, D, Sk, B * KV, BK)) {
    return -2;
  }
  const int smem = Smem<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (Sk + BK - 1) / BK * B * H;
  dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(partial), static_cast<int*>(counters), H, KV, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the int32 counters a launch needs, one per (batch, kv-head, k-tile)
int tft_flash_dkv_sm90_counters(int B, int KV, int Sk) { return B * KV * ((Sk + BK - 1) / BK); }

// for G = H / KV > 1: ``partial``, f32 scratch of 2·B·H·Sk·D (the per-q-head
// partials of dk, then of dv), and ``counters``, tft_flash_dkv_sm90_counters
// int32 zeros; both may be null for G = 1
int tft_flash_dkv_sm90(const void* q, const void* k, const void* v, const void* lse,
                       const void* dout, const void* delta, void* dk, void* dv, void* partial,
                       void* counters, int B, int H, int KV, int Sq, int Sk, int D, float scale,
                       int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, lse, dout, delta, dk, dv, partial, counters, B, H, KV, Sq,
                            Sk, scale, causal, s);
    case 128:
      return launch_dkv<128>(q, k, v, lse, dout, delta, dk, dv, partial, counters, B, H, KV, Sq,
                             Sk, scale, causal, s);
    default: return -1;
  }
}

const char* tft_cuda_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim";
    case -2: return "cuTensorMapEncodeTiled refused a tensor map";
    case -3: return "the driver has no cuTensorMapEncodeTiled";
    case -4: return "the GQA group sum needs its scratch and counters";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
