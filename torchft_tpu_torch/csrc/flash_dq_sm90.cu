// Causal / full GQA flash-attention dQ for Hopper (sm_90a): wgmma products,
// a TMA ring of K/V tiles, dQ in registers.
//
// Replaces the Pallas TPU kernel _dq_kernel of
// torchft_tpu/ops/flash_attention.py (:213, the first pallas_call of _bwd;
// its per-tile math is _recompute_p_ds at :183).  It computes what that
// kernel and flash_dq_plain (torchft_tpu_torch/ops/flash_attention.py)
// compute: dq [B, H, Sq, D] bf16 from q and do [B, H, Sq, D], k and v
// [B, KV, Sk, D] (bf16) and lse and delta [B, H, Sq] (f32), with
// p = exp(s·scale − lse) (masked scores are −1e30, never −inf) and
// ds = p·(dp − delta)·scale in f32, rounded to bf16 before dq = Σ_k ds·k,
// which is summed in f32.  q-head h reads kv-head h / (H / KV): grouped K/V
// are never repeated.
//
// What bounds it on an H100: at the Llama-3-8B shapes (S = 2048, H = 32,
// KV = 8, D = 128, causal) it does 51.6 GFLOP on ~59 MB, ~870 FLOP per byte,
// far above the ~295 FLOP/byte ridge of bf16, so the bound is the tensor
// cores' rate.  What the design does about it:
// - every product is wgmma: S = Q·K^T and dP = dO·V^T are SS (the Q or dO
//   rows as A, the K or V tile as B, both K-major); their m64n64
//   accumulators, turned into dS in place and packed into bf16 pairs, are
//   the register A fragments of dQ += dS·K, an RS product that reads the
//   same K tile MN-major (the transpose-B descriptor).  No tile is
//   transposed and no score touches shared memory;
// - one block owns 128 q-rows of one q-head: two warpgroups of 64 rows and
//   nothing else.  A block of 9 or 12 warps caps a thread at 168 registers
//   (ptxas then spills and serializes the wgmma); 8 warps may take 255.
//   Q and dO arrive once by TMA and stay resident, and dQ stays in
//   registers (64 f32 a thread at D = 128, beside S and dP, 32 each) until
//   the epilogue writes bf16 pairs straight from them.  No block adds to
//   another's rows, so there is no scratch and no counter, and two
//   launches are bit-identical;
// - warp 0 also loads: it streams K and V tiles of 64 keys through a
//   STAGES-deep TMA ring ("full" barriers counting transaction bytes,
//   "empty" barriers counting the releases of all 256 threads), refilling
//   a stage once every thread is done with it.  A thread's lse and delta
//   are those of its two rows, read once by plain loads;
// - only k-tiles that reach the block's rows are visited (causal: keys
//   below q0 + 128), the q-tiles with the most k-tiles are scheduled first,
//   and a warpgroup skips its products on a tile wholly above its rows
//   (warpgroup 0 on the block's last causal tile), still waiting on and
//   releasing the stage like every thread.
//
// TMA maps are 3-D, (D, S, batch x heads): a Q or dO tile past row Sq of one
// head reads zeros, and its rows are masked (p = 0) since their lse is not
// defined; keys past Sk read zeros and are masked too.
//
// tft_flash_dq_sm90 returns cudaGetLastError() after its launch (0 = ok),
// -1 for a head dim other than 64 or 128, -2 if a tensor map could not be
// encoded, -3 if cuTensorMapEncodeTiled could not be resolved.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;    // q rows per block: two consumer warpgroups of 64
constexpr int BK = 64;     // keys per ring tile
constexpr int STAGES = 3;  // K/V ring depth
constexpr int BOX = 64;    // columns per TMA box: 128 bytes, the swizzle span
constexpr int Q_BOX_BYTES = BQ * BOX * 2;  // one [128 q rows][64] box
constexpr int K_BOX_BYTES = BK * BOX * 2;  // one [64 keys][64] box
constexpr int THREADS = 256;               // two warpgroups and nothing else
constexpr float NEG_INF = -1e30f;          // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

// dynamic shared memory, from a 1024-byte aligned base: Q and dO (each
// [128 rows][D] as D / 64 swizzled boxes), the K and V rings (each tile
// [64 keys][D]), the barriers
template <int D>
struct Smem {
  static constexpr int Q_TILE = D / BOX * Q_BOX_BYTES;
  static constexpr int K_TILE = D / BOX * K_BOX_BYTES;
  static constexpr int Q = 0;
  static constexpr int DO = Q + Q_TILE;
  static constexpr int K = DO + Q_TILE;
  static constexpr int V = K + STAGES * K_TILE;
  static constexpr int BARS = V + STAGES * K_TILE;  // q_full, full[STAGES], empty[STAGES]
  static constexpr int bytes = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int H, int KV, int Sq, int Sk, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Smem<D>::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // the longest causal rows first: the last q-tiles walk the most k-tiles
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int qz = b * H + h;                 // the block's (batch, q-head)
  const int kz = b * KV + h / (H / KV);     // and its (batch, kv-head)
  // causally dead k-tiles (wholly above the block's rows) are never visited
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], THREADS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // lane 0 of warp 0 loads, besides its share of the products: k-tile i
  // into stage i % STAGES; the ring runs STAGES tiles ahead
  auto load = [&](int i) {
    const int s = i % STAGES;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * Smem<D>::K_TILE);
    for (int c = 0; c < D / BOX; ++c) {
      sm90::tma_load_3d(smem + Smem<D>::K + s * Smem<D>::K_TILE + c * K_BOX_BYTES, &k_map,
                        &full[s], c * BOX, i * BK, kz);
      sm90::tma_load_3d(smem + Smem<D>::V + s * Smem<D>::K_TILE + c * K_BOX_BYTES, &v_map,
                        &full[s], c * BOX, i * BK, kz);
    }
  };
  if (threadIdx.x == 0) {
    sm90::tma_prefetch(&k_map);
    sm90::tma_prefetch(&v_map);
    sm90::mbar_arrive_expect_tx(q_full, 2 * Smem<D>::Q_TILE);
    for (int c = 0; c < D / BOX; ++c) {
      sm90::tma_load_3d(smem + Smem<D>::Q + c * Q_BOX_BYTES, &q_map, q_full, c * BOX, q0, qz);
      sm90::tma_load_3d(smem + Smem<D>::DO + c * Q_BOX_BYTES, &do_map, q_full, c * BOX, q0, qz);
    }
    for (int i = 0; i < STAGES && i < n_tiles; ++i) load(i);
  }

  // warpgroup wg owns q rows [qb, qb + 64), qb = q0 + 64 wg; this thread
  // holds rows row0 and row0 + 8 (accumulator rows), key columns
  // 8j + col0 + {0, 1} of S and dP, and D columns 8j + col0 + {0, 1} of dQ
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int qb = q0 + wg * 64;
  const int row0 = qb + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;  // scores are kept in log2 units

  // this thread's rows' lse (log2 units) and delta; rows past Sq read 0,
  // and their p is masked to 0
  float lse_log2[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool ok = row < Sq;
    lse_log2[r] = ok ? lse[(size_t)qz * Sq + row] * LOG2E : 0.f;
    delta_r[r] = ok ? delta[(size_t)qz * Sq + row] : 0.f;
  }

  // operand descriptors at the start of this warpgroup's 64 Q and dO rows
  // (64 rows of 128 B in each box) and of stage 0's K and V tiles, K-major
  // for S and dP, and of the K tile MN-major for dQ (LBO: the next
  // 64-column box of the 64-key tile)
  const uint64_t q_desc = sm90::desc_sw128(smem + Smem<D>::Q + wg * 64 * 128, 16, 1024);
  const uint64_t do_desc = sm90::desc_sw128(smem + Smem<D>::DO + wg * 64 * 128, 16, 1024);
  const uint64_t k_desc = sm90::desc_sw128(smem + Smem<D>::K, 16, 1024);
  const uint64_t v_desc = sm90::desc_sw128(smem + Smem<D>::V, 16, 1024);
  const uint64_t k_desc_mn = sm90::desc_sw128(smem + Smem<D>::K, K_BOX_BYTES, 1024);

  float acc_dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;

  sm90::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    const uint32_t stage = s * Smem<D>::K_TILE;
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);

    // a tile whose keys all follow this warpgroup's rows, or a warpgroup
    // whose rows all lie past Sq, adds nothing
    if (!((causal && k0 > qb + 63) || qb >= Sq)) {
      // S = Q · K^T, then dP = dO · V^T: all K-major, D / 16 slices of 32
      // bytes inside 64-column boxes; two groups, so that p can be
      // computed while dP is in flight
      float acc_s[BK / 2], acc_dp[BK / 2];
      const uint64_t qd = sm90::opaque(q_desc), kd = sm90::opaque(k_desc) + (stage >> 4);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int qa = (kk / 4) * Q_BOX_BYTES + (kk % 4) * 32;
        const int ka = (kk / 4) * K_BOX_BYTES + (kk % 4) * 32;
        sm90::wgmma_ss<BK, 0>(acc_s, sm90::desc_add(qd, qa), sm90::desc_add(kd, ka), kk > 0);
      }
      sm90::wgmma_commit();
      const uint64_t dod = sm90::opaque(do_desc), vd = sm90::opaque(v_desc) + (stage >> 4);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int qa = (kk / 4) * Q_BOX_BYTES + (kk % 4) * 32;
        const int ka = (kk / 4) * K_BOX_BYTES + (kk % 4) * 32;
        sm90::wgmma_ss<BK, 0>(acc_dp, sm90::desc_add(dod, qa), sm90::desc_add(vd, ka), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(acc_s);

      // P = exp(S·scale − lse) in place; element 4j + 2r + e is row
      // row0 + 8r, key k0 + 8j + col0 + e.  Only tiles that cross the
      // diagonal, Sq or Sk test each element.
      const bool edge = (causal && k0 + BK - 1 > qb) || k0 + BK > Sk || qb + 64 > Sq;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + col0 + e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 4 * j + 2 * r + e;
            float sl = acc_s[idx] * scale_log2;
            bool dead = false;
            if (edge) {
              const int row = row0 + 8 * r;
              // a masked score is the reference's -1e30 before the exp
              if (causal && key > row) sl = NEG_INF * LOG2E;
              dead = key >= Sk || row >= Sq;
            }
            acc_s[idx] = dead ? 0.f : exp2f(sl - lse_log2[r]);
          }
        }
      }

      // dS = P · (dP − delta) · scale, packed in bf16 pairs: registers
      // 8kk .. 8kk + 7 are the A fragment of k16 slice kk (keys 16kk ..)
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_dp);
      uint32_t ds_frag[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i0 = 8 * kk + 2 * rr;  // row row0 + 8 (rr % 2)
          const float dl = delta_r[rr & 1];
          const float ds0 = acc_s[i0] * (acc_dp[i0] - dl) * scale;
          const float ds1 = acc_s[i0 + 1] * (acc_dp[i0 + 1] - dl) * scale;
          __nv_bfloat162 dd = __floats2bfloat162_rn(ds0, ds1);
          ds_frag[kk][rr] = *reinterpret_cast<uint32_t*>(&dd);
        }
      }

      // dQ += dS · K: K is [keys][D], MN-major for this product; each k16
      // slice is 16 keys (2048 bytes) down every 64-column box
      const uint64_t km = sm90::opaque(k_desc_mn) + (stage >> 4);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        sm90::wgmma_rs<D, 1>(acc_dq, ds_frag[kk], sm90::desc_add(km, kk * 2048), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_dq);
    }
    sm90::mbar_arrive(&empty[s]);  // every thread releases every stage
    if (threadIdx.x < 32 && i + STAGES < n_tiles) {
      sm90::mbar_wait(&empty[s], (i / STAGES) & 1);  // every thread is done with tile i
      if (lane == 0) load(i + STAGES);
      __syncwarp();
    }
  }

  // epilogue: bf16 pairs straight from the registers, rows below Sq only
  const size_t row_base = (size_t)qz * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* dst = dq + (row_base + row) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc_dq[4 * j + 2 * r], acc_dq[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* lse, const void* dout,
              const void* delta, void* dq, int B, int H, int KV, int Sq, int Sk, float scale,
              int causal, cudaStream_t stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Sk == 0) {  // no key: the gradient is 0
    return (int)cudaMemsetAsync(dq, 0, (size_t)B * H * Sq * D * 2, stream);
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
      cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, KV, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tft_flash_dq_sm90(const void* q, const void* k, const void* v, const void* lse,
                      const void* dout, const void* delta, void* dq, int B, int H, int KV, int Sq,
                      int Sk, int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, lse, dout, delta, dq, B, H, KV, Sq, Sk, scale, causal, s);
    case 128:
      return launch_dq<128>(q, k, v, lse, dout, delta, dq, B, H, KV, Sq, Sk, scale, causal, s);
    default: return -1;
  }
}

const char* tft_cuda_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim";
    case -2: return "cuTensorMapEncodeTiled refused a tensor map";
    case -3: return "cuTensorMapEncodeTiled could not be resolved";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
