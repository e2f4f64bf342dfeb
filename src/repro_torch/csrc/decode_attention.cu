// decode_attention — flash-decode GQA over a contiguous KV cache, for Hopper
// (sm_90a): the drain path's attention.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (body _kernel, online-softmax step _flash_update).  One query token per
// batch row attends over S cached positions under a shared (S,) validity
// mask (position and sliding window).  Like the TPU kernel it keeps q in
// float32, upcasts K/V to float32, starts the running max at -1e30, gives
// masked positions probability 0 and finishes with acc / max(l, 1e-30).
//
// What bounds it on the H100: HBM bytes.  A bf16 cache is read once,
// 2*B*S_valid*K*D*2 bytes, against ~4*B*H*S_valid*D float32 operations:
// about G = H/K operations per byte, well under the ALU line.  Reading
// those bytes fast takes many SMs at once: a block per (kv head, batch row)
// gives the L tier's B 4 x K 2 only 8 blocks for 132 SMs, each walking all
// S positions.
//
// What the design does about that:
//   * the positions are split across blocks: the grid is (kv head, batch
//     row, split), each split a contiguous range of positions whose length
//     the host picks from the shapes alone (B * K and S; 32-position splits
//     give the L tier 256 blocks), never from the mask, which would need a
//     copy to the host: the call stays capturable in a CUDA graph;
//   * each block runs the online softmax over its range for the G query
//     heads of its kv head, which share every K/V byte it reads, and writes
//     a partial (m, l, acc) to a float32 workspace the wrapper allocates;
//     a second, small kernel (decode_attention_combine_kernel) merges the
//     splits in a fixed order, so two calls give the same bits, and writes
//     acc / max(l, 1e-30);
//   * rows are staged in shared memory with cp.async, 16 bytes a thread, in
//     two stages: the next tile's copies are in flight while this tile is
//     computed.  The mask is read once per tile as a byte row; tiles, and
//     rows inside a tile, that the mask excludes are never read.  A split
//     whose positions are all masked reads no K/V and writes m = -1e30,
//     l = 0, acc = 0;
//   * the arithmetic stays float32 FMA (at G <= 8 tensor cores buy nothing
//     on a byte-bound kernel): each warp keeps its own online-softmax state
//     for the G heads in registers over the rows it owns (lanes split D),
//     two rows at a time, every head's shuffle reduction and update
//     interleaved and branch-free (a branch per head and shuffle round
//     cost more than the work); the warps' states merge once at the end,
//     by a fixed tree through the stages' shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;      // query heads per kv head
constexpr int kMaxSplits = 256;   // splits per (batch row, kv head)
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The workspace holds, per (batch row, kv head, split), acc (G, D) then
// m (G) then l (G), float32; m in log2 units (the softmax runs on exp2).
// Two blocks per SM (at most 128 registers a thread) up to D 128: the
// host's split rule sizes the grid for that.  At D 256 128 registers spill.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
decode_attention_split_kernel(const float* __restrict__ q,
                              const T* __restrict__ cache_k,
                              const T* __restrict__ cache_v,
                              const uint8_t* __restrict__ valid,
                              float* __restrict__ ws, int s_len, int kv_heads,
                              int group, int split_len, float scale) {
  // lane l owns elements [l * kEpl, l * kEpl + kEpl) below D; where D is
  // not a multiple of 32 (80, 120) the last lanes own fewer or none
  constexpr int kLanes = D >= 32 ? 32 : D;       // lanes that own elements
  constexpr int kEpl = (D + kLanes - 1) / kLanes;  // elements per lane
  // 8 KB per tile and operand: two stages of K and V stay under 48 KB
  constexpr int kTile = (8192 / (D * (int)sizeof(T))) < 64
                            ? 8192 / (D * (int)sizeof(T)) : 64;
  constexpr int kVec = 16 / (int)sizeof(T);      // elements per 16 bytes
  constexpr int kVecPerRow = D / kVec;
  static_assert(D % kVec == 0, "a cache row must be whole 16-byte vectors");

  // rows a warp takes at once (their chains interleave)
  constexpr int kRb = kTile / kWarps >= 2 ? 2 : 1;
  constexpr int kStage = kTile * D * (int)sizeof(T);   // one operand's tile
  // raw bytes: a __shared__ array of a class type (bf16) may not be declared.
  // [stage][K | V]; after the loop it holds the warps' merge
  __shared__ __align__(16) unsigned char kv_raw[2 * 2 * kStage];
  static_assert(kWarps / 2 * kMaxGroup * D * 4 <= 2 * 2 * kStage,
                "the merge fits the stages");
  __shared__ uint8_t m_tile[2][kTile];
  __shared__ float m_part[kWarps][kMaxGroup];
  __shared__ float l_part[kWarps][kMaxGroup];

  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool owns = lane < kLanes;
  const int e0 = lane * kEpl;
  const int lo = sp * split_len;
  const int hi = lo + split_len < s_len ? lo + split_len : s_len;

  // q pre-scaled by scale * log2(e): scores come out in log2 units
  float qr[kMaxGroup][kEpl];
  float acc[kMaxGroup][kEpl];
  float m[kMaxGroup], l[kMaxGroup];
  const float* qb = q + (static_cast<int64_t>(b) * kv_heads + kh) * group * D;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      qr[g][e] = (g < group && owns && e0 + e < D)
                     ? qb[g * D + e0 + e] * (scale * kLog2e) : 0.f;
      acc[g][e] = 0.f;
    }
  }

  const int64_t row_stride = static_cast<int64_t>(kv_heads) * D;
  const T* kb = cache_k + static_cast<int64_t>(b) * s_len * row_stride +
                static_cast<int64_t>(kh) * D;
  const T* vb = cache_v + static_cast<int64_t>(b) * s_len * row_stride +
                static_cast<int64_t>(kh) * D;

  // stage tile t: its mask bytes, then copies of the rows the mask keeps;
  // returns whether it keeps any
  auto stage = [&](int t, int st) -> int {
    const int s0 = lo + t * kTile;
    int keep = 0;
    if (tid < kTile) {
      const int s = s0 + tid;
      keep = s < hi ? valid[s] : 0;
      m_tile[st][tid] = keep;
    }
    const int any = __syncthreads_or(keep);
    if (any) {
      T* kt = reinterpret_cast<T*>(kv_raw + (2 * st) * kStage);
      T* vt = reinterpret_cast<T*>(kv_raw + (2 * st + 1) * kStage);
      for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
        const int r = i / kVecPerRow, c = i % kVecPerRow;
        if (!m_tile[st][r]) continue;
        const int64_t off = (s0 + r) * row_stride + c * kVec;
        cp_async16(kt + i * kVec, kb + off);
        cp_async16(vt + i * kVec, vb + off);
      }
    }
    cp_async_commit();
    return any;
  };

  const int nt = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  int any_cur = nt > 0 ? stage(0, 0) : 0;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    int any_next = 0;
    if (t + 1 < nt)
      any_next = stage(t + 1, st ^ 1);
    else
      cp_async_commit();                 // keep one group per tile
    cp_async_wait1();
    __syncthreads();
    if (any_cur) {
      const T* k_tile =
          reinterpret_cast<const T*>(kv_raw + (2 * st) * kStage);
      const T* v_tile =
          reinterpret_cast<const T*>(kv_raw + (2 * st + 1) * kStage);
      // the warp's rows warp, warp + kWarps, ... kRb at a time.  The
      // kMaxGroup heads' dot products reduce in interleaved shuffles and
      // their online-softmax steps are independent.  Heads past G (q rows
      // of zeros) run too and are never written out, and a masked row
      // reads as zeros and weighs 0: straight-line code, where a branch
      // per head, row and shuffle round costs more than the work
      for (int r0 = warp; r0 < kTile; r0 += kRb * kWarps) {
        float kf[kRb][kEpl], vf[kRb][kEpl];
        bool keep[kRb];
#pragma unroll
        for (int i = 0; i < kRb; ++i) {
          const int r = r0 + i * kWarps;
          keep[i] = r < kTile && m_tile[st][r];
#pragma unroll
          for (int e = 0; e < kEpl; ++e) {
            const bool in = keep[i] && owns && e0 + e < D;
            kf[i][e] = in ? to_float(k_tile[r * D + e0 + e]) : 0.f;
            vf[i][e] = in ? to_float(v_tile[r * D + e0 + e]) : 0.f;
          }
        }
        float dot[kRb][kMaxGroup];
#pragma unroll
        for (int i = 0; i < kRb; ++i)
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            dot[i][g] = 0.f;
#pragma unroll
            for (int e = 0; e < kEpl; ++e)
              dot[i][g] = fmaf(qr[g][e], kf[i][e], dot[i][g]);
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int i = 0; i < kRb; ++i)
#pragma unroll
            for (int g = 0; g < kMaxGroup; ++g)
              dot[i][g] += __shfl_xor_sync(0xffffffffu, dot[i][g], off);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          float m_new = m[g];
#pragma unroll
          for (int i = 0; i < kRb; ++i)
            m_new = fmaxf(m_new, keep[i] ? dot[i][g] : kNeg);
          const float corr = exp2f(m[g] - m_new);
          float p[kRb];
          float psum = 0.f;
#pragma unroll
          for (int i = 0; i < kRb; ++i) {
            p[i] = keep[i] ? exp2f(dot[i][g] - m_new) : 0.f;
            psum += p[i];
          }
          m[g] = m_new;
          l[g] = l[g] * corr + psum;
#pragma unroll
          for (int e = 0; e < kEpl; ++e) {
            float a = acc[g][e] * corr;
#pragma unroll
            for (int i = 0; i < kRb; ++i) a = fmaf(p[i], vf[i][e], a);
            acc[g][e] = a;
          }
        }
      }
    }
    __syncthreads();  // the stage is overwritten two tiles on
    any_cur = any_next;
  }

  // Merge the warps' online-softmax states: each scales its acc to the
  // common max, then a tree over the warps in a fixed order (deterministic
  // sums) through the stages' shared memory; warp 0 ends with the sum.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      m_part[warp][g] = m[g];
      l_part[warp][g] = l[g];
    }
  }
  __syncthreads();
  float m_all[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m_all[g] = kNeg;
    for (int w = 0; w < kWarps; ++w) m_all[g] = fmaxf(m_all[g], m_part[w][g]);
    const float f = exp2f(m[g] - m_all[g]);
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[g][e] *= f;
  }
  float* red = reinterpret_cast<float*>(kv_raw);   // [warp][g][D]
#pragma unroll
  for (int half = kWarps / 2; half > 0; half /= 2) {
    if (warp >= half && warp < 2 * half && owns) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
        for (int e = 0; e < kEpl; ++e)
          if (e0 + e < D)
            red[((warp - half) * kMaxGroup + g) * D + e0 + e] = acc[g][e];
    }
    __syncthreads();
    if (warp < half && owns) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
        for (int e = 0; e < kEpl; ++e)
          if (e0 + e < D) acc[g][e] += red[(warp * kMaxGroup + g) * D + e0 + e];
    }
    __syncthreads();
  }
  const int n_split = gridDim.z;
  float* wb = ws + ((static_cast<int64_t>(b) * kv_heads + kh) * n_split + sp) *
                       group * (D + 2);
  if (warp == 0 && owns) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;
#pragma unroll
      for (int e = 0; e < kEpl; ++e)
        if (e0 + e < D) wb[g * D + e0 + e] = acc[g][e];
    }
  }
  if (tid < group) {
    const int g = tid;
    float mx = kNeg, lt = 0.f;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_part[w][g]);
    for (int w = 0; w < kWarps; ++w)
      lt += l_part[w][g] * exp2f(m_part[w][g] - mx);
    wb[group * D + g] = mx;
    wb[group * D + group + g] = lt;
  }
}

// One block per (kv head, batch row, query head): merges the head's n_split
// partials in split order and writes acc / max(l, 1e-30).  Warp 0 turns the
// splits' m into weights (lanes over splits, a fixed shuffle tree for the
// max and for l); then each thread sums its output columns over the splits,
// in order, with the loads of several splits in flight.
__global__ void __launch_bounds__(128)
decode_attention_combine_kernel(const float* __restrict__ ws,
                                float* __restrict__ out, int kv_heads,
                                int group, int d, int n_split) {
  constexpr int kPer = kMaxSplits / 32;           // splits per lane
  __shared__ float w[kMaxSplits];
  __shared__ float l_all;
  const int kh = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x;
  const int stride = group * (d + 2);             // one split's partial
  const float* wb =
      ws + (static_cast<int64_t>(b) * kv_heads + kh) * n_split * stride;
  if (tid < 32) {
    float m[kPer], l[kPer];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int sp = tid + 32 * j;
      const bool in = sp < n_split;
      m[j] = in ? wb[sp * stride + group * d + g] : kNeg;
      l[j] = in ? wb[sp * stride + group * d + group + g] : 0.f;
      mx = fmaxf(mx, m[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lt = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int sp = tid + 32 * j;
      const float f = exp2f(m[j] - mx);
      if (sp < n_split) w[sp] = f;
      lt += f * l[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    if (tid == 0) l_all = fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  float* ob = out + ((static_cast<int64_t>(b) * kv_heads + kh) * group + g) * d;
  const float* ab = wb + g * d;
  for (int i = tid; i < d; i += 128) {
    float a = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_split; ++sp) a += w[sp] * ab[sp * stride + i];
    ob[i] = a / l_all;
  }
}

template <typename T, int D>
void launch_split(const void* q, const void* k, const void* v,
                  const void* valid, float* ws, int b, int s, int kv,
                  int group, int split_len, int n_split, float scale,
                  cudaStream_t st) {
  decode_attention_split_kernel<T, D><<<dim3(kv, b, n_split), kThreads, 0,
                                        st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid), ws, s,
      kv, group, split_len, scale);
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* valid, float* ws, int b, int s, int kv, int group,
               int split_len, int n_split, float scale, cudaStream_t st) {
#define SPLIT_CASE(D_)                                                      \
  case D_:                                                                  \
    launch_split<T, D_>(q, k, v, valid, ws, b, s, kv, group, split_len,     \
                        n_split, scale, st);                                \
    break;
  switch (d) {
    SPLIT_CASE(16)
    SPLIT_CASE(32)
    SPLIT_CASE(64)
    SPLIT_CASE(80)
    SPLIT_CASE(120)
    SPLIT_CASE(128)
    SPLIT_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPLIT_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, 1, H, D) float32; cache_k/v: (B, S, K, D) of `dtype` (0 = float32,
// 1 = bfloat16); valid: (S,) bytes; ws: float32 workspace of
// B * K * ceil(S / split_len) * group * (D + 2); out: (B, 1, H, D) float32.
// All contiguous; H = K * group with group <= 8; D in {16, 32, 64, 80, 120,
// 128, 256}; at most 256 splits.  Two launches: the splits, then their merge.
// Returns the first cudaGetLastError() that is not 0, else 0.
extern "C" int decode_attention_launch(const void* q, const void* cache_k,
                                       const void* cache_v, const void* valid,
                                       void* ws, void* out, int dtype, int b,
                                       int s, int kv, int group, int d,
                                       int split_len, float scale,
                                       void* stream) {
  if (group < 1 || group > kMaxGroup || split_len < 1 || b < 1 || s < 1 ||
      kv < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = (s + split_len - 1) / split_len;
  if (n_split > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const int err =
      dtype == 0 ? dispatch_d<float>(d, q, cache_k, cache_v, valid, w, b, s,
                                     kv, group, split_len, n_split, scale, st)
                 : dispatch_d<__nv_bfloat16>(d, q, cache_k, cache_v, valid, w,
                                             b, s, kv, group, split_len,
                                             n_split, scale, st);
  if (err) return err;
  decode_attention_combine_kernel<<<dim3(kv, b, group), 128, 0, st>>>(
      w, static_cast<float*>(out), kv, group, d, n_split);
  return static_cast<int>(cudaGetLastError());
}
