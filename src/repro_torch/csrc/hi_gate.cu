// hi_gate — the fused HI decision module for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hi_gate.py, hi_gate_pallas (body _kernel).
// For (N, C) logits, one pass computes the row-softmax statistics, the
// confidence (max_prob | margin | entropy), the first-index argmax `pred`
// and `offload = conf < *theta`.
//
// What bounds it on the H100: HBM bytes.  It reads N*C*itemsize bytes once
// (4.86 MB for the S tier's (8, 151,936) float32 logits: 1.45 us at 3.35
// TB/s) and does a few operations per element, far below the ~20 float32
// operations per byte where the ALUs would bound it.  At a few MB the rate
// is set by the bytes in flight: by Little's law the card needs about 2 MB
// of loads outstanding, some 15-25 KiB per SM, to stream at full rate.
// One block per row, scalar loads and an online update per element (the
// first design) kept 8 SMs busy with about 16 KiB in flight each: 32 us on
// an H100 at 700 W.
// Past the bytes, what a launch of a few us pays for is latency: the DRAM
// round trip, the cross-block merge, and cold instruction fetch, since code
// that runs once per launch comes from memory line by line.
//
// What the design does about that:
// * Each row is split into contiguous column ranges, one block each, with
//   the count from the shapes alone (hi_gate.py gate_splits): about two
//   blocks per SM in all, at least 2,048 columns and at most 32 splits, one
//   split for small C.  On the path: (8, 151,936) 32 splits of ~4,750
//   columns, 256 blocks; (4, 151,936) and (2, 151,936) 32; (8, 50,280) 24;
//   (8, 32,000) 15.
// * A block of 512 threads, each issuing up to kVecs = 4 16-byte loads (4
//   float32 or 8 bf16 each) before any arithmetic on them: up to 32 KiB in
//   flight per block (256 threads with 8 loads each, or 128, measured
//   slower; the smaller unrolled body is also less code to fetch).  A row
//   that starts off a 16-byte boundary (C = 7, 4,099) takes its head and
//   tail as scalars.
// * Per thread and batch of loads, the max, the first index of the max
//   `arg` and t2 (the largest logit other than the one at `arg`; a
//   duplicated max gives t2 == m, hence margin 0, as the reference's masked
//   second max does) come first, from the values held in registers; then
//   one exp (exp2f) per element against that max accumulates
//     z  = sum e^(x-m),   s1 = sum e^(x-m)(x-m).
//   No rescale and no branch per element: selects only.
// * States (m, z, s1, t2, arg) merge across a warp in two steps, the max
//   first, then one exp per lane and sums, a min and a max in butterflies
//   (warp_merge() below; argmax ties go to the lower index).  One copy of
//   that code serves the block's lanes, then its warps, then the row's
//   splits: a block of a split row writes its partial to a workspace and
//   counts itself on its row's counter (a release-acquire atomic); the
//   last block of the row merges the partials, split i in lane i, so the
//   bits do not depend on which block finished last, derives
//     max_prob = 1/z,  margin = (1 - e^(t2-m))/z,
//     entropy  = 1 - (log z - s1/z)/log C,
//   and resets the counter to 0 for the next call.  One launch a call.
//   (A thread-block cluster merging over distributed shared memory measured
//   slower on the path's shapes: a cluster holds at most 16 blocks, so a
//   row streams through fewer SMs.)
// Theta is read through a device pointer, so a moving threshold never needs
// a host round trip.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;           // 16-byte loads in flight per thread
constexpr int kPartialWords = 8;   // one split's (m, z, s1, t2, arg) + pad
constexpr int kMaxSplits = 32;     // the row's splits merge one a lane

struct State {
  float m, z, s1, t2;
  int arg;
};

__device__ __forceinline__ State empty_state() {
  return {-CUDART_INF_F, 0.f, 0.f, -CUDART_INF_F, 0x7fffffff};
}

// The elements of one 16-byte vector, as float32.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static float at(const uint4& v, int u) {
    return __uint_as_float(u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w);
  }
  __device__ __forceinline__ static float one(const float* p) {
    return __ldg(p);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static float at(const uint4& v, int u) {
    const int q = u >> 1;
    const unsigned w = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
    // little-endian: the even element is the low half
    return __uint_as_float((u & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

constexpr float kLog2e = 1.4426950408889634f;

// e^d for d <= 0, on the SFU's exp2 (2 ulp)
__device__ __forceinline__ float exp_neg(float d) {
  return exp2f(d * kLog2e);
}

// Merge state b into a; the two cover disjoint column sets.
__device__ __forceinline__ void merge(State& a, const State& b) {
  if (b.z == 0.f) return;
  if (a.z == 0.f) { a = b; return; }
  const float m = fmaxf(a.m, b.m);
  const float da = a.m - m, db = b.m - m;
  const float ea = exp_neg(da), eb = exp_neg(db);
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

// Every lane ends with the merge of the warp's 32 states, in two steps with
// one exp per lane and none in the trees: the warp's max M first; then each
// lane's (z, s1) rescaled to M and summed, the lowest `arg` among lanes whose
// max is M, and t2 = M when two lanes hold M, else the largest of the M
// lane's t2 and the other lanes' maxima.  The butterflies' order is fixed.
__device__ __forceinline__ State warp_merge(const State& s) {
  float M = s.m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  const bool live = s.z > 0.f;
  const bool top = live && s.m == M;
  const float d = s.m - M;
  const float e = live ? exp_neg(d) : 0.f;
  float z = e * s.z;
  float s1 = live ? e * fmaf(d, s.z, s.s1) : 0.f;
  int arg = top ? s.arg : 0x7fffffff;
  float t2 = live ? (top ? s.t2 : s.m) : -CUDART_INF_F;
  int tops = top ? 1 : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    z += __shfl_xor_sync(0xffffffffu, z, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    arg = min(arg, __shfl_xor_sync(0xffffffffu, arg, o));
    t2 = fmaxf(t2, __shfl_xor_sync(0xffffffffu, t2, o));
    tops += __shfl_xor_sync(0xffffffffu, tops, o);
  }
  return {M, z, s1, tops > 1 ? M : t2, arg};
}

// grid: splits * n blocks, block b = (row b / splits, split b % splits).
// out: conf (n float32), then pred (n int32), then offload (n int32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
hi_gate_kernel(const T* __restrict__ logits, int n, int c, int splits,
               int metric, const float* __restrict__ theta,
               float* __restrict__ out, float* __restrict__ ws,
               int* __restrict__ counters) {
  using P = Pack<T>;
  constexpr int V = P::kN;
  const int row = blockIdx.x / splits, split = blockIdx.x % splits;
  const int tid = threadIdx.x;
  const T* x = logits + static_cast<int64_t>(row) * c;

  // the row's 16-byte-aligned body [a0, a1), nv vectors of V, cut into
  // splits of `per` vectors; the head [0, a0) and tail [a1, c) are scalar
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15) / sizeof(T));
  const int a0 = min(c, mis ? V - mis : 0);
  const int nv = (c - a0) / V;
  const int a1 = a0 + nv * V;
  const int per = (nv + splits - 1) / splits;
  const int vlo = min(nv, split * per), vhi = min(nv, vlo + per);
  const uint4* body = reinterpret_cast<const uint4*>(x + a0);

  // the unaligned head (split 0, its first threads) and tail (the last
  // split, its last threads), one element a thread, start those states
  State s = empty_state();
  if (split == 0 && tid < a0)
    s = State{P::one(x + tid), 1.f, 0.f, -CUDART_INF_F, tid};
  const int tail = c - a1;
  if (split == splits - 1 && tid >= kThreads - tail) {
    const int col = a1 + tid - (kThreads - tail);
    s = State{P::one(x + col), 1.f, 0.f, -CUDART_INF_F, col};
  }
  for (int v0 = vlo + tid; v0 < vhi; v0 += kVecs * kThreads) {
    uint4 raw[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int j = v0 + k * kThreads;
      raw[k] = j < vhi ? __ldg(body + j) : make_uint4(0u, 0u, 0u, 0u);
    }
    // max, first argmax and t2 over the values in registers (vectors past
    // the split skipped; v0 < vhi, so the first is always there)
    float mc = -CUDART_INF_F, t2 = -CUDART_INF_F;
    int arg = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (v0 + k * kThreads < vhi) {
        const int col = a0 + (v0 + k * kThreads) * V;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float v = P::at(raw[k], u);
          t2 = fmaxf(t2, fminf(v, mc));   // v > mc: the old max; else v
          arg = v > mc ? col + u : arg;   // increasing columns: first wins
          mc = fmaxf(mc, v);
        }
      }
    }
    // one exp per element against mc
    float z = 0.f, s1 = 0.f;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (v0 + k * kThreads < vhi) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float d = P::at(raw[k], u) - mc;
          const float e = exp_neg(d);
          z += e;
          s1 = fmaf(e, d, s1);
        }
      }
    }
    merge(s, State{mc, z, s1, t2, arg});
  }
  // One copy of warp_merge's code serves three levels, so that only the
  // first finds it cold in the instruction cache (code that runs once per
  // launch is fetched from memory line by line): the lanes of each warp,
  // then the block's warps in warp 0, then, in the last block of a split
  // row, the row's splits, one a lane.
  __shared__ State part[kWarps];
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll 1
  for (int level = 0;; ++level) {
    s = warp_merge(s);
    if (level == 0) {
      if (lane == 0) part[warp] = s;
      __syncthreads();
      if (warp != 0) return;
      s = lane < kWarps ? part[lane] : empty_state();
    } else if (level == 1 && splits > 1) {
      float* row_ws = ws + static_cast<int64_t>(row) * splits * kPartialWords;
      int last = 0;
      if (lane == 0) {
        float* mine = row_ws + split * kPartialWords;
        mine[0] = s.m;
        mine[1] = s.z;
        mine[2] = s.s1;
        mine[3] = s.t2;
        reinterpret_cast<int*>(mine)[4] = s.arg;
        // release: the partial is visible to the block that sees the count
        // reach splits; acquire: that block sees every partial
        int old;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                     : "=r"(old) : "l"(counters + row) : "memory");
        last = old == splits - 1;
      }
      if (!__shfl_sync(0xffffffffu, last, 0)) return;
      __syncwarp();
      s = empty_state();
      if (lane < splits) {
        const float* p = row_ws + lane * kPartialWords;
        s = State{__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3),
                  __ldcg(reinterpret_cast<const int*>(p) + 4)};
      }
      if (lane == 0) counters[row] = 0;  // ready for the next call
    } else {
      break;
    }
  }
  if (lane != 0) return;

  float cf;
  if (metric == 0) {
    cf = 1.f / s.z;
  } else if (metric == 1) {
    cf = (1.f - expf(s.t2 - s.m)) / s.z;
  } else {
    cf = 1.f - (logf(s.z) - s.s1 / s.z) / logf(static_cast<float>(c));
  }
  int32_t* pred = reinterpret_cast<int32_t*>(out + n);
  out[row] = cf;
  pred[row] = s.arg;
  pred[n + row] = cf < *theta ? 1 : 0;
}

}  // namespace

// dtype: 0 = float32 logits, 1 = bfloat16.  metric: 0 max_prob, 1 margin,
// 2 entropy.  out: a (3, n) int32 buffer (conf as float32, pred, offload).
// splits (1..32) > 1 needs ws (n * splits * 8 floats) and counters (n
// ints, 0 on entry; the kernel leaves them 0).  Returns cudaGetLastError() after the
// launch.
extern "C" int hi_gate_launch(const void* logits, int dtype, int n, int c,
                              int splits, int metric, const void* theta,
                              void* out, void* ws, void* counters,
                              void* stream) {
  static_assert(kWarps <= 32, "the block's warps merge in one warp");
  if (n < 1 || c < 2 || splits < 1 || splits > kMaxSplits ||
      static_cast<int64_t>(n) * splits > 0x7fffffff ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* th = static_cast<const float*>(theta);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  const unsigned grid = static_cast<unsigned>(n) * splits;
  if (dtype == 0) {
    hi_gate_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(logits), n, c, splits, metric, th, o, w,
        cnt);
  } else {
    hi_gate_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), n, c, splits, metric, th,
        o, w, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
