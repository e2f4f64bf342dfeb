// decode_attention — flash-decode GQA over a contiguous KV cache, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (body _kernel, online-softmax step _flash_update).  One query token per
// batch row attends over S cached positions under a shared (S,) validity
// mask (position and sliding window).  Like the TPU kernel it keeps q in
// float32, upcasts K/V tiles to float32, starts the running max at -1e30,
// gives masked positions probability 0, and finishes with
// acc / max(l, 1e-30).
//
// What bounds it on the H100: HBM bytes.  A bf16 cache is read once,
// 2*B*S_valid*K*D*2 bytes, against ~4*B*H*S_valid*D float32 operations:
// about G = H/K operations per byte, well under the ALU line.
//
// What the design does about that:
//   * one block per (kv head, batch row): the G = H/K query heads of the
//     group share every K/V byte read, so each byte leaves HBM once;
//   * the cache is streamed in tiles of TS positions staged in shared
//     memory with 16-byte loads, neighbouring threads on neighbouring
//     addresses;
//   * the mask is read once per tile as a byte row (not broadcast to
//     (B, S) as the TPU wrapper does), and tiles, and rows inside a tile,
//     that the mask excludes are never read: at decode most of a long cache
//     lies past the current position or outside the window;
//   * each warp keeps its own online-softmax state for the G heads in
//     registers over the rows it owns; the warps' states are merged once at
//     the end.
// With B*K blocks the grid fills few of the 132 SMs at serving batch sizes;
// splitting S across blocks and wgmma/TMA are left for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;      // query heads per kv head
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const T* __restrict__ cache_k,
                        const T* __restrict__ cache_v,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, int s_len, int kv_heads,
                        int group, float scale) {
  constexpr int kLanes = D >= 32 ? 32 : D;       // lanes that own elements
  constexpr int kEpl = D / kLanes;               // elements per lane
  constexpr int kTile = (16384 / (D * (int)sizeof(T))) < 64
                            ? 16384 / (D * (int)sizeof(T)) : 64;
  constexpr int kVec = 16 / (int)sizeof(T);      // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  static_assert(D % kVec == 0, "a cache row must be whole 16-byte vectors");

  // raw bytes: a __shared__ array of a class type (bf16) may not be declared
  __shared__ __align__(16) unsigned char k_raw[kTile * D * sizeof(T)];
  __shared__ __align__(16) unsigned char v_raw[kTile * D * sizeof(T)];
  T* k_tile = reinterpret_cast<T*>(k_raw);
  T* v_tile = reinterpret_cast<T*>(v_raw);
  __shared__ uint8_t m_tile[kTile];
  __shared__ float acc_sum[kMaxGroup * D];
  __shared__ float m_part[kWarps][kMaxGroup];
  __shared__ float l_part[kWarps][kMaxGroup];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool owns = lane < kLanes;
  const int e0 = lane * kEpl;

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
      qr[g][e] = (g < group && owns) ? qb[g * D + e0 + e] : 0.f;
      acc[g][e] = 0.f;
    }
  }

  const int64_t row_stride = static_cast<int64_t>(kv_heads) * D;
  const T* kb = cache_k + static_cast<int64_t>(b) * s_len * row_stride +
                static_cast<int64_t>(kh) * D;
  const T* vb = cache_v + static_cast<int64_t>(b) * s_len * row_stride +
                static_cast<int64_t>(kh) * D;

  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    int live = 0;
    if (tid < kTile) {
      const int s = s0 + tid;
      m_tile[tid] = (s < s_len) ? valid[s] : 0;
      live = m_tile[tid];
    }
    if (!__syncthreads_or(live)) continue;  // the whole tile is masked

    for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow, c = i % kVecPerRow;
      if (!m_tile[r]) continue;
      const int64_t off = (s0 + r) * row_stride + c * kVec;
      reinterpret_cast<int4*>(k_tile)[i] =
          *reinterpret_cast<const int4*>(kb + off);
      reinterpret_cast<int4*>(v_tile)[i] =
          *reinterpret_cast<const int4*>(vb + off);
    }
    __syncthreads();

    for (int r = warp; r < kTile; r += kWarps) {
      if (!m_tile[r]) continue;
      float kf[kEpl], vf[kEpl];
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        kf[e] = owns ? to_float(k_tile[r * D + e0 + e]) : 0.f;
        vf[e] = owns ? to_float(v_tile[r * D + e0 + e]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= group) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) dot = fmaf(qr[g][e], kf[e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float score = dot * scale;
        const float m_new = fmaxf(m[g], score);
        const float corr = expf(m[g] - m_new);
        const float p = expf(score - m_new);
        m[g] = m_new;
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) acc[g][e] = acc[g][e] * corr + p * vf[e];
      }
    }
    __syncthreads();  // the tile is overwritten next iteration
  }

  // Merge the warps' online-softmax states.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      m_part[warp][g] = m[g];
      l_part[warp][g] = l[g];
    }
  }
  for (int i = tid; i < group * D; i += kThreads) acc_sum[i] = 0.f;
  __syncthreads();
  float m_all[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m_all[g] = kNeg;
    for (int w = 0; w < kWarps; ++w) m_all[g] = fmaxf(m_all[g], m_part[w][g]);
  }
  for (int w = 0; w < kWarps; ++w) {  // fixed order: deterministic sums
    if (warp == w && owns) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= group) break;
        const float f = expf(m[g] - m_all[g]);
#pragma unroll
        for (int e = 0; e < kEpl; ++e) acc_sum[g * D + e0 + e] += acc[g][e] * f;
      }
    }
    __syncthreads();
  }
  float* ob = out + (static_cast<int64_t>(b) * kv_heads + kh) * group * D;
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D;
    float lt = 0.f;
    for (int w = 0; w < kWarps; ++w)
      lt += l_part[w][g] * expf(m_part[w][g] - m_all[g]);
    ob[i] = acc_sum[i] / fmaxf(lt, 1e-30f);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* valid,
            void* out, int b, int s, int kv, int group, float scale,
            cudaStream_t st) {
  decode_attention_kernel<T, D><<<dim3(kv, b), kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), s, kv, group, scale);
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* valid, void* out, int b, int s, int kv, int group,
               float scale, cudaStream_t st) {
  switch (d) {
    case 16: launch<T, 16>(q, k, v, valid, out, b, s, kv, group, scale, st); break;
    case 32: launch<T, 32>(q, k, v, valid, out, b, s, kv, group, scale, st); break;
    case 64: launch<T, 64>(q, k, v, valid, out, b, s, kv, group, scale, st); break;
    case 128: launch<T, 128>(q, k, v, valid, out, b, s, kv, group, scale, st); break;
    case 256: launch<T, 256>(q, k, v, valid, out, b, s, kv, group, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, 1, H, D) float32; cache_k/v: (B, S, K, D) of `dtype` (0 = float32,
// 1 = bfloat16); valid: (S,) bytes; out: (B, 1, H, D) float32.  All
// contiguous; H = K * group with group <= 8; D in {16, 32, 64, 128, 256}.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(const void* q, const void* cache_k,
                                       const void* cache_v, const void* valid,
                                       void* out, int dtype, int b, int s,
                                       int kv, int group, int d, float scale,
                                       void* stream) {
  if (group < 1 || group > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, cache_k, cache_v, valid, out, b, s, kv,
                             group, scale, st);
  return dispatch_d<__nv_bfloat16>(d, q, cache_k, cache_v, valid, out, b, s,
                                   kv, group, scale, st);
}
