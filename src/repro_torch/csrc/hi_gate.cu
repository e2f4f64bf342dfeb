// hi_gate — the fused HI decision module for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hi_gate.py, hi_gate_pallas (body _kernel).
// For (N, C) logits, one pass computes the row-softmax statistics, the
// confidence (max_prob | margin | entropy), the first-index argmax `pred`
// and `offload = conf < *theta`.
//
// What bounds it on the H100: HBM bytes.  It reads N*C*itemsize bytes once
// and does a few operations per byte (one exp, a compare, two FMAs), far
// below the ~20 float32 operations per byte where the ALUs would bound it.
//
// What the design does about that: the TPU kernel keeps whole rows in VMEM;
// one f32 row of qwen2's 151,936-token vocabulary is 594 KiB, more than the
// 227 KB of shared memory a block may use.  So nothing is staged: one block
// owns one row, each thread streams its strided columns once from HBM
// (neighbouring threads on neighbouring addresses) and keeps online
// statistics in registers:
//   m   running max,        z  = sum e^(x-m),
//   s1  = sum e^(x-m)(x-m)  (rescaled on a new max m' as
//                            s1' = e^(m-m')(s1 + (m-m') z)),
//   arg first index of the max,
//   t2  largest logit other than the one at `arg` (a duplicated max gives
//       t2 == m, hence margin 0, as the reference's masked second max does).
// A warp-shuffle + shared-memory reduction merges the per-thread states
// (argmax ties go to the lower index), and thread 0 derives
//   max_prob = 1/z,  margin = (1 - e^(t2-m))/z,
//   entropy  = 1 - (log z - s1/z)/log C.
// Theta is read through a device pointer, so a moving threshold never needs
// a host round trip.  With N = 8 rows only 8 SMs work; splitting C across
// blocks is left for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct State {
  float m, z, s1, t2;
  int arg;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Fold one element (value x at column i, i larger than every index seen by
// this state) into a thread's running state.
__device__ __forceinline__ void push(State& s, float x, int i) {
  if (x > s.m) {
    if (s.z > 0.f) {
      const float d = s.m - x;
      const float e = expf(d);
      s.s1 = e * (s.s1 + d * s.z);
      s.z *= e;
    }
    s.t2 = s.m;  // the old max is now a non-argmax element
    s.m = x;
    s.arg = i;
  } else {
    s.t2 = fmaxf(s.t2, x);  // x == m at a later index also lands here
  }
  const float d = x - s.m;
  const float e = expf(d);
  s.z += e;
  s.s1 += e * d;
}

// Merge state b into a; the two cover disjoint column sets.
__device__ __forceinline__ void merge(State& a, const State& b) {
  if (b.z == 0.f) return;
  if (a.z == 0.f) { a = b; return; }
  const float m = fmaxf(a.m, b.m);
  const float da = a.m - m, db = b.m - m;
  const float ea = expf(da), eb = expf(db);
  const float z = ea * a.z + eb * b.z;
  const float s1 = ea * (a.s1 + da * a.z) + eb * (b.s1 + db * b.z);
  float t2;
  int arg;
  if (a.m > b.m) {
    arg = a.arg; t2 = fmaxf(a.t2, b.m);
  } else if (b.m > a.m) {
    arg = b.arg; t2 = fmaxf(b.t2, a.m);
  } else {  // equal maxima: the max is duplicated, the lower index wins
    arg = min(a.arg, b.arg); t2 = m;
  }
  a.m = m; a.z = z; a.s1 = s1; a.t2 = t2; a.arg = arg;
}

__device__ __forceinline__ State shfl_down(const State& s, int off) {
  State o;
  o.m = __shfl_down_sync(0xffffffffu, s.m, off);
  o.z = __shfl_down_sync(0xffffffffu, s.z, off);
  o.s1 = __shfl_down_sync(0xffffffffu, s.s1, off);
  o.t2 = __shfl_down_sync(0xffffffffu, s.t2, off);
  o.arg = __shfl_down_sync(0xffffffffu, s.arg, off);
  return o;
}

__device__ __forceinline__ void warp_reduce(State& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge(s, shfl_down(s, off));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hi_gate_kernel(const T* __restrict__ logits, int c, int metric,
               const float* __restrict__ theta, float* __restrict__ conf,
               int32_t* __restrict__ pred, int32_t* __restrict__ offload) {
  const int row = blockIdx.x;
  const T* x = logits + static_cast<int64_t>(row) * c;
  State s{-CUDART_INF_F, 0.f, 0.f, -CUDART_INF_F, 0x7fffffff};

  // Four independent loads in flight per thread before the dependent
  // state updates.
  int i = threadIdx.x;
  for (; i + 3 * kThreads < c; i += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = to_float(x[i + u * kThreads]);
#pragma unroll
    for (int u = 0; u < 4; ++u) push(s, v[u], i + u * kThreads);
  }
  for (; i < c; i += kThreads) push(s, to_float(x[i]), i);

  warp_reduce(s);
  __shared__ State part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp != 0) return;
  s = part[lane];  // kWarps == 32: one partial state per lane
  warp_reduce(s);
  if (lane != 0) return;

  float cf;
  if (metric == 0) {
    cf = 1.f / s.z;
  } else if (metric == 1) {
    cf = (1.f - expf(s.t2 - s.m)) / s.z;
  } else {
    cf = 1.f - (logf(s.z) - s.s1 / s.z) / logf(static_cast<float>(c));
  }
  conf[row] = cf;
  pred[row] = s.arg;
  offload[row] = cf < *theta ? 1 : 0;
}

}  // namespace

// dtype: 0 = float32 logits, 1 = bfloat16.  metric: 0 max_prob, 1 margin,
// 2 entropy.  Returns cudaGetLastError() after the launch.
extern "C" int hi_gate_launch(const void* logits, int dtype, int n, int c,
                              int metric, const void* theta, void* conf,
                              void* pred, void* offload, void* stream) {
  static_assert(kWarps == 32, "the second reduction stage assumes 32 warps");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* th = static_cast<const float*>(theta);
  float* cf = static_cast<float*>(conf);
  int32_t* pr = static_cast<int32_t*>(pred);
  int32_t* of = static_cast<int32_t*>(offload);
  if (dtype == 0) {
    hi_gate_kernel<float><<<n, kThreads, 0, st>>>(
        static_cast<const float*>(logits), c, metric, th, cf, pr, of);
  } else {
    hi_gate_kernel<__nv_bfloat16><<<n, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), c, metric, th, cf, pr, of);
  }
  return static_cast<int>(cudaGetLastError());
}
