// DiLoCo's sharded outer update on Hopper (sm_90a): one pass per pipeline
// chunk on the shard's owner.
//
// Replaces no Pallas kernel: it takes the place of the host arithmetic of
// the sharded outer sync, the chunk sum of torchft_tpu/collectives.py
// (np.sum(np.stack(gathered), axis=0), then acc *= 1/P) and the outer
// optimizer's step on the shard (torchft_tpu/local_sgd.py _cb: optax.sgd;
// the port's optim.OuterSGD.update in numpy).  Per element i of the chunk:
//
//   g  = c[0][i] when w = 1, else
//        ((0 + c[0][i]) + c[1][i]) + ... + c[w-1][i]   (ascending, from +0)
//   g  = g * scale                             (scale = f32(1/P))
//   t' = g + m * t[i]                          (with momentum)
//   d  = g + m * t'  (Nesterov) | t' (momentum) | g (no momentum)
//   delta[i] = (-lr) * d,  new_trace[i] = t'
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn, which
// nvcc never contracts into a fused multiply-add, whatever --fmad says), so
// the result is numpy's bit for bit on every finite, infinite, signed-zero
// and subnormal value (the build keeps denormals).  The sum starts from +0,
// as numpy's sum over axis 0 does (and the int8 path's einsum), so a sum of
// -0s is +0; one contribution (world size 1) is taken as it is, as the host
// path scales its chunk without summing.
// A NaN result is the card's canonical NaN, where x86 carries an operand's
// payload: the values differ only in NaN bits.
//
// What bounds it on an H100: w + 5 flops an element against (w + 3) * 4
// bytes (w contributions and the trace read, the trace and the delta
// written), far below the ridge, so bytes at 3.35 TB/s.  A simple
// grid-stride kernel: each thread takes runs of 4 elements with 16-byte
// loads and stores where every row starts on 16 bytes, element by element
// otherwise and on the ragged tail.
//
// trace and new_trace may be one buffer (the trace updated in place): each
// element is read once, by the thread that then writes it, so the pointers
// are not restrict.
//
// The entry point returns cudaGetLastError() after its launch (0 = ok), or
// -1 for a bad mode, count or pointer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 4;  // elements a thread handles per step (one float4)

constexpr int MODE_SGD = 0;       // no momentum: d = g
constexpr int MODE_MOMENTUM = 1;  // d = t'
constexpr int MODE_NESTEROV = 2;  // d = g + m * t'

struct Args {
  const float* contribs;  // [w, n], row k at contribs + k * n
  int w;
  int64_t n;
  float scale, momentum, neg_lr;
  const float* trace;  // [n], unused without momentum
  float* new_trace;    // [n], may be trace
  float* delta;        // [n]
};

__device__ __forceinline__ void load_run(const float* p, int64_t base, int64_t n, bool vec,
                                         float (&x)[RUN]) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(p + base);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < RUN; ++k) x[k] = (base + k < n) ? p[base + k] : 0.f;
}

__device__ __forceinline__ void store_run(float* p, int64_t base, int64_t n, bool vec,
                                          const float (&x)[RUN]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + base) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    if (base + k < n) p[base + k] = x[k];
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) outer_kernel(Args a, bool aligned) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS * RUN;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * RUN;
       base < a.n; base += stride) {
    const bool vec = aligned && base + RUN <= a.n;
    float g[RUN], c[RUN];
    load_run(a.contribs, base, a.n, vec, g);
    if (a.w > 1) {
#pragma unroll
      for (int j = 0; j < RUN; ++j) g[j] = __fadd_rn(0.f, g[j]);
    }
    for (int k = 1; k < a.w; ++k) {
      load_run(a.contribs + k * a.n, base, a.n, vec, c);
#pragma unroll
      for (int j = 0; j < RUN; ++j) g[j] = __fadd_rn(g[j], c[j]);
    }
    float d[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) g[j] = __fmul_rn(g[j], a.scale);
    if (MODE == MODE_SGD) {
#pragma unroll
      for (int j = 0; j < RUN; ++j) d[j] = g[j];
    } else {
      float t[RUN];
      load_run(a.trace, base, a.n, vec, t);
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        t[j] = __fadd_rn(g[j], __fmul_rn(a.momentum, t[j]));
        d[j] = (MODE == MODE_NESTEROV) ? __fadd_rn(g[j], __fmul_rn(a.momentum, t[j])) : t[j];
      }
      store_run(a.new_trace, base, a.n, vec, t);
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j) d[j] = __fmul_rn(a.neg_lr, d[j]);
    store_run(a.delta, base, a.n, vec, d);
  }
}

template <int MODE>
void launch(const Args& a, bool aligned, cudaStream_t st) {
  const int64_t runs = (a.n + RUN - 1) / RUN;
  const int64_t blocks = (runs + THREADS - 1) / THREADS;
  const unsigned grid = static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
  outer_kernel<MODE><<<grid, THREADS, 0, st>>>(a, aligned);
}

bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// The outer update of n elements from w contributions ([w, n] f32, rows
// contiguous): delta = (-lr) * d, and new_trace = t' unless mode is 0.
// mode 0: no momentum; 1: momentum; 2: Nesterov momentum.  All scalars are
// f32, as the host casts them.
int tft_outer_update(const void* contribs, int w, long long n, float scale, float momentum,
                     float neg_lr, int mode, const void* trace, void* new_trace, void* delta,
                     void* stream) {
  if (w < 1 || n < 0 || mode < MODE_SGD || mode > MODE_NESTEROV) return -1;
  if (contribs == nullptr || delta == nullptr) return -1;
  if (mode != MODE_SGD && (trace == nullptr || new_trace == nullptr)) return -1;
  if (n == 0) return 0;
  Args a{static_cast<const float*>(contribs), w, n, scale, momentum, neg_lr,
         static_cast<const float*>(trace), static_cast<float*>(new_trace),
         static_cast<float*>(delta)};
  // every row of the contributions starts on 16 bytes when n is a multiple
  // of 4 and the base pointers are aligned
  const bool aligned = n % RUN == 0 && on16(contribs) && on16(delta) &&
                       (mode == MODE_SGD || (on16(trace) && on16(new_trace)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == MODE_SGD) {
    launch<MODE_SGD>(a, aligned, st);
  } else if (mode == MODE_MOMENTUM) {
    launch<MODE_MOMENTUM>(a, aligned, st);
  } else {
    launch<MODE_NESTEROV>(a, aligned, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tft_outer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
