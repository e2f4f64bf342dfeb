// grouped_ffn — the routed experts of a MoE layer for Hopper (sm_90a): the
// routing of a pass's tokens and the grouped SwiGLU product over the experts
// that hold a (token, choice) pair.
//
// Replaces no TPU kernel: the reference runs its routed FFN as three
// batched einsums over capacity-bounded (E, cap, D) buffers, which read
// every expert's weights and drop the pairs past an expert's capacity.
// Here every pair of a live token runs through its expert, with no
// capacity, in float32 with IEEE products (no TF32), as the configurations
// state.
//
// Routing (moe_route_launch, two kernels).  Per token: the softmax over the
// E experts, the top K (descending, ties to the lower expert, lax.top_k's
// order), the K gates renormalised; a dead token's K pairs go to a last
// bucket E.  Then the T*K pair ids t*K + j are sorted by bucket, stably:
// each token adds at most one pair to an expert, so the stable order inside
// an expert's run is token order, and a counting sort gives it.
//   * route_topk_kernel: one block per kRouteTokens tokens, one warp per
//     token at a time (each lane holds E/32 of the probabilities; K rounds
//     of a warp argmax).  It writes the gates, each pair's bucket, and the
//     block's count per bucket.
//   * route_scatter_kernel: one block per the same tokens.  Thread b sums
//     bucket b's counts over all blocks and over the blocks before its own;
//     a block scan over the buckets gives their starts, so each block knows
//     where its tokens' pairs of each expert go, and one warp writes them in
//     token order.  Block 0 writes the E + 1 offsets (offsets[E]: the live
//     pairs).  Nothing depends on the order the blocks run in.
// Two launches serve every pass, from a decode step's 8 tokens (one block)
// to the chunk lane's 2,048 (64 blocks).
//
// The product (grouped_swiglu_launch: moe_gate_up_kernel, moe_down_kernel).  Over the pairs sorted
// by expert, expert e's run being pairs[offsets[e] .. offsets[e+1]):
//   gate_up: h[r] = silu(x[t] Wg[e]) * (x[t] Wi[e]),   t = pairs[r] / K
//   down:    out[pairs[r]] = gate[pairs[r]] * h[r] Wo[e]
// h (P, F) is kept by sorted row; out (P, D) by pair id, zero rows for the
// dead pairs (the caller zero-fills it).
//
// What bounds it on the H100.  A decode step of the L tier routes 48 pairs
// over ~34 of 64 experts: the step streams the hit experts' weights once,
// 1.2 GB a layer of deepseek-moe-16b at 3.35 TB/s.  The chunk lane's 12,288
// pairs give every expert ~192 rows: 2*3*D*F FLOPs a pair on the float32
// FMA units (67 TFLOP/s), bound by compute.
//
// What the design does about that:
//   * a block owns one BM-row tile of one expert's run and one BN-column
//     tile of the output, so a weight tile is read once per row tile; BM
//     follows the pass's mean run (grouped_ffn.py tiles(): 8 for a decode
//     step's 1-12 rows, 32, 64 for the chunk lane's ~192).  The launch grid
//     is sized from the shapes for the worst case (at most P/BM + E row
//     tiles); each block finds its expert and rows from the device offsets
//     with one warp scan, and a block past the last tile returns at once.
//     Nothing is read back to the host;
//   * 16 thread columns by BM / TM thread rows, each thread with a TM x TN
//     register tile (gate_up: one tile for Wg and one for Wi over the same
//     rows, so x is loaded once for both); the operands' next BK-deep slice
//     is loaded from global memory into registers (16-byte loads, the x rows
//     gathered by token) while the block multiplies the slice in shared
//     memory, then stored to the other of two buffers: one barrier per
//     slice.  A weight element in shared memory is read by BM / TM threads
//     and used in BM FMAs, so a decode step, whose rows are mostly empty,
//     takes the 8-row tile with TM = 2 (64 threads, BK = 32: 16 KiB of
//     weights in flight per block, six blocks an SM): a 16 x 16 grid over
//     16 rows read each weight 16 times from shared memory and ran at 41% of
//     the bytes' bound on an H100.  The chunk lane's 64-row tile takes
//     TM = 4 in 256 threads;
//   * a thread's TN columns are groups of 4 spaced BN / (TN / 4) apart, so
//     a warp's 16-byte shared-memory reads of a weight row are contiguous;
//   * rows past a run's end load zeros and store nothing, and a dead token
//     is in no run: its x row is never read, nor an unhit expert's weights;
//   * the sum over D (or F) runs in the same order on every call, with no
//     atomics, so a call gives the same bits every time.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRouteTokens = 32;     // tokens per routing block
constexpr int kMaxExperts = kThreads - 1;  // E + 1 buckets, one a thread
constexpr int kMaxPerLane = (kMaxExperts + 31) / 32;
constexpr int kMaxK = 32;            // the K choices, one a lane

// ---------------------------------------------------------------------------
// routing
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
route_topk_kernel(const float* __restrict__ logits, int ld,
                  const unsigned char* __restrict__ live, int T, int E, int K,
                  float* __restrict__ gate, int* __restrict__ bucket,
                  int* __restrict__ counts) {
  __shared__ int hist[kMaxExperts + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b <= E; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int t0 = blockIdx.x * kRouteTokens;
  const int t1 = min(T, t0 + kRouteTokens);
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const float* row = logits + static_cast<int64_t>(t) * ld;
    float v[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < E ? row[e] : -CUDART_INF_F;
    }
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) m = fmaxf(m, v[i]);
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      v[i] = lane + 32 * i < E ? expf(v[i] - m) : 0.f;
      s += v[i];
    }
    s = warp_sum(s);
    // the probabilities; -1 marks an expert that is not there, -2 a taken one
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i)
      v[i] = lane + 32 * i < E ? v[i] / s : -1.f;
    float my_g = 0.f, sum = 0.f;
    int my_e = 0;
    for (int j = 0; j < K; ++j) {
      float bv = -2.f;
      int be = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i)
        if (v[i] > bv) {   // strict: the lower expert of a lane's ties
          bv = v[i];
          be = lane + 32 * i;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oe = __shfl_xor_sync(0xffffffffu, be, o);
        if (ov > bv || (ov == bv && oe < be)) {
          bv = ov;
          be = oe;
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i)
        if (lane + 32 * i == be) v[i] = -2.f;
      if (lane == j) {
        my_g = bv;
        my_e = be;
      }
      sum += bv;
    }
    if (lane < K) {
      // a token whose logits hold a NaN selects no expert: dead
      const bool alive = (live == nullptr || live[t] != 0) && my_e < E;
      const int b = alive ? my_e : E;
      gate[t * K + lane] = my_g / fmaxf(sum, 1e-9f);
      bucket[t * K + lane] = b;
      atomicAdd(&hist[b], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b <= E; b += kThreads)
    counts[blockIdx.x * (E + 1) + b] = hist[b];
}

__global__ void __launch_bounds__(kThreads)
route_scatter_kernel(const int* __restrict__ bucket,
                     const int* __restrict__ counts, int T, int E, int K,
                     int64_t* __restrict__ pairs, int64_t* __restrict__ offsets) {
  __shared__ int base[kThreads];
  __shared__ int warp_tot[kWarps];
  const int b = threadIdx.x, lane = b & 31, warp = b >> 5;
  const int blocks = gridDim.x;
  int tot = 0, before = 0;
  if (b <= E) {
    for (int c = 0; c < blocks; ++c) {
      const int n = counts[c * (E + 1) + b];
      tot += n;
      if (c < static_cast<int>(blockIdx.x)) before += n;
    }
  }
  // exclusive scan of the buckets' totals: their starts
  int inc = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int carry = 0;
  for (int w = 0; w < warp; ++w) carry += warp_tot[w];
  const int start = carry + inc - tot;
  if (b <= E) {
    base[b] = start + before;
    if (blockIdx.x == 0) offsets[b] = start;
  }
  __syncthreads();
  if (warp != 0) return;
  const int t0 = blockIdx.x * kRouteTokens;
  const int t1 = min(T, t0 + kRouteTokens);
  for (int t = t0; t < t1; ++t) {
    // a live token's K experts differ; a dead token's K pairs share bucket
    // E and take K consecutive slots
    const int bk = lane < K ? bucket[t * K + lane] : -1;
    int pos = 0;
    if (bk >= 0) pos = base[bk] + (bk == E ? lane : 0);
    __syncwarp();
    if (bk >= 0) {
      pairs[pos] = static_cast<int64_t>(t) * K + lane;
      if (bk != E) base[bk] = pos + 1;
      else if (lane == 0) base[E] = pos + K;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// the grouped product
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK, int TM, int TN, bool UP>
struct Tile {
  static constexpr int kNB = UP ? 2 : 1;   // weight operands
  static constexpr int kTX = BN / TN, kTY = BM / TM;
  static constexpr int kN = kTX * kTY;        // threads
  static_assert(kTX == 16 && kN % 32 == 0, "16 thread columns, whole warps");
  static_assert(TN % 4 == 0 && BK % 4 == 0, "16-byte operands");
  static constexpr int kNG = TN / 4;          // a thread's column groups
  static constexpr int kAPad = 4;
  static constexpr int kAVec = BM * BK / 4;   // float4 of an x/h slice
  static constexpr int kBVec = BK * BN / 4;   // float4 of a weight slice
  static constexpr int kAPer = (kAVec + kN - 1) / kN;
  static constexpr int kBPer = kBVec / kN;
  static_assert(kBVec % kN == 0, "whole weight slices");
};

// The expert and rows [row0, row_end) of row tile `tile`: -1 past the last.
template <int BM>
__device__ __forceinline__ void find_tile(const int64_t* __restrict__ offsets,
                                          int E, int tile, int* s_e,
                                          int* s_row0, int* s_row_end) {
  const int lane = threadIdx.x;
  if (lane == 0) *s_e = -1;
  __syncwarp();
  int carry = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int lo = e < E ? static_cast<int>(offsets[e]) : 0;
    const int hi = e < E ? static_cast<int>(offsets[e + 1]) : 0;
    const int n = (hi - lo + BM - 1) / BM;
    int inc = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    const int first = carry + inc - n;
    if (tile >= first && tile < first + n) {
      *s_e = e;
      *s_row0 = lo + (tile - first) * BM;
      *s_row_end = hi;
    }
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
}

template <int BM, int BN, int BK, int TM, int TN, bool UP>
__device__ __forceinline__ void
grouped_body(const float* __restrict__ a, int64_t lda,
               const int64_t* __restrict__ pairs,
               const int64_t* __restrict__ offsets,
               const float* __restrict__ w0, const float* __restrict__ w1,
               int kdim, int n, int E, int K, const float* __restrict__ gate,
               float* __restrict__ out, int64_t ldo) {
  using C = Tile<BM, BN, BK, TM, TN, UP>;
  __shared__ __align__(16) float As[2][BK][BM + C::kAPad];
  __shared__ __align__(16) float Bs[C::kNB][2][BK][BN];
  __shared__ int s_e, s_row0, s_row_end;
  __shared__ int64_t s_src[BM];

  if (threadIdx.x < 32)
    find_tile<BM>(offsets, E, blockIdx.x, &s_e, &s_row0, &s_row_end);
  __syncthreads();
  const int e = s_e;
  if (e < 0) return;
  const int row0 = s_row0, row_end = s_row_end;
  const int n0 = blockIdx.y * BN;
  // each tile row's source row of `a` (x: its token; h: the row itself),
  // -1 past the run
  for (int r = threadIdx.x; r < BM; r += C::kN) {
    const int row = row0 + r;
    s_src[r] = row < row_end ? (UP ? pairs[row] / K : row) : -1;
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int tx = tid % C::kTX, ty = tid / C::kTX;
  const int64_t wstride = static_cast<int64_t>(kdim) * n;
  const float* wb[2] = {w0 + e * wstride, UP ? w1 + e * wstride : nullptr};

  float4 ra[C::kAPer];
  float4 rb[C::kNB][C::kBPer];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < C::kAPer; ++i) {
      const int v = tid + i * C::kN;
      const int r = v / (BK / 4), kq = v % (BK / 4);
      const int64_t src = v < C::kAVec ? s_src[r] : -1;
      const int k = k0 + 4 * kq;
      ra[i] = (src >= 0 && k < kdim)
                  ? *reinterpret_cast<const float4*>(a + src * lda + k)
                  : zero;
    }
#pragma unroll
    for (int m = 0; m < C::kNB; ++m)
#pragma unroll
      for (int i = 0; i < C::kBPer; ++i) {
        const int v = tid + i * C::kN;
        const int kk = v / (BN / 4), c = 4 * (v % (BN / 4));
        const int k = k0 + kk, col = n0 + c;
        rb[m][i] = (k < kdim && col < n)
                       ? *reinterpret_cast<const float4*>(
                             wb[m] + static_cast<int64_t>(k) * n + col)
                       : zero;
      }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < C::kAPer; ++i) {
      const int v = tid + i * C::kN;
      if (v < C::kAVec) {
        const int r = v / (BK / 4), kq = v % (BK / 4);
        As[buf][4 * kq + 0][r] = ra[i].x;
        As[buf][4 * kq + 1][r] = ra[i].y;
        As[buf][4 * kq + 2][r] = ra[i].z;
        As[buf][4 * kq + 3][r] = ra[i].w;
      }
    }
#pragma unroll
    for (int m = 0; m < C::kNB; ++m)
#pragma unroll
      for (int i = 0; i < C::kBPer; ++i) {
        const int v = tid + i * C::kN;
        const int kk = v / (BN / 4), c = 4 * (v % (BN / 4));
        *reinterpret_cast<float4*>(&Bs[m][buf][kk][c]) = rb[m][i];
      }
  };

  float acc[C::kNB][TM][TN];
#pragma unroll
  for (int m = 0; m < C::kNB; ++m)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[m][i][j] = 0.f;

  const int steps = (kdim + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load((s + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float af[TM], bf[C::kNB][TN];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              &As[cur][kk][ty * TM + i]);
          af[i] = v.x;
          af[i + 1] = v.y;
          af[i + 2] = v.z;
          af[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) af[i] = As[cur][kk][ty * TM + i];
      }
#pragma unroll
      for (int m = 0; m < C::kNB; ++m)
#pragma unroll
        for (int g = 0; g < C::kNG; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(
              &Bs[m][cur][kk][g * (BN / C::kNG) + 4 * tx]);
          bf[m][4 * g + 0] = w.x;
          bf[m][4 * g + 1] = w.y;
          bf[m][4 * g + 2] = w.z;
          bf[m][4 * g + 3] = w.w;
        }
#pragma unroll
      for (int m = 0; m < C::kNB; ++m)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[m][i][j] = fmaf(af[i], bf[m][j], acc[m][i][j]);
    }
    if (s + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int row = row0 + r;
    if (row >= row_end) continue;
    int64_t dst = row;
    float scale = 1.f;
    if (!UP) {
      dst = pairs[row];
      scale = gate[dst];
    }
#pragma unroll
    for (int g = 0; g < C::kNG; ++g) {
      const int col = n0 + g * (BN / C::kNG) + 4 * tx;
      if (col >= n) continue;
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x0 = acc[0][i][4 * g + q];
        if (UP) {
          const float x1 = acc[C::kNB - 1][i][4 * g + q];
          o[q] = x0 / (1.f + expf(-x0)) * x1;
        } else {
          o[q] = x0 * scale;
        }
      }
      *reinterpret_cast<float4*>(out + dst * ldo + col) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// gate_up: (BM x 64) tiles of h, TM rows by 4 columns a thread, 16 * BM / TM
// threads
template <int BM, int BK, int TM>
__global__ void __launch_bounds__(16 * BM / TM)
moe_gate_up_kernel(const float* __restrict__ x, int64_t ldx,
                   const int64_t* __restrict__ pairs,
                   const int64_t* __restrict__ offsets,
                   const float* __restrict__ wg, const float* __restrict__ wi,
                   int D, int F, int E, int K, float* __restrict__ h) {
  grouped_body<BM, 64, BK, TM, 4, true>(x, ldx, pairs, offsets, wg, wi, D, F,
                                        E, K, nullptr, h, F);
}

// down: (BM x 128) tiles of out, TM rows by 8 columns a thread
template <int BM, int BK, int TM>
__global__ void __launch_bounds__(16 * BM / TM)
moe_down_kernel(const float* __restrict__ h,
                const int64_t* __restrict__ pairs,
                const int64_t* __restrict__ offsets,
                const float* __restrict__ wo, int D, int F, int E, int K,
                const float* __restrict__ gate, float* __restrict__ out) {
  grouped_body<BM, 128, BK, TM, 8, false>(h, F, pairs, offsets, wo, nullptr,
                                          F, D, E, K, gate, out, D);
}

template <int BM, int BK, int TM>
int launch_grouped(const float* x, int64_t ldx, const int64_t* pairs,
                   const int64_t* offsets, const float* wg, const float* wi,
                   const float* wo, const float* gate, float* h, float* out,
                   int D, int F, int E, int K, int m_tiles,
                   cudaStream_t stream) {
  constexpr int threads = 16 * BM / TM;
  moe_gate_up_kernel<BM, BK, TM>
      <<<dim3(m_tiles, (F + 63) / 64), threads, 0, stream>>>(
          x, ldx, pairs, offsets, wg, wi, D, F, E, K, h);
  moe_down_kernel<BM, BK, TM>
      <<<dim3(m_tiles, (D + 127) / 128), threads, 0, stream>>>(
          h, pairs, offsets, wo, D, F, E, K, gate, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits (T, E) float32, row stride ld, last dim contiguous; live (T,) bool
// or null (every token routes); gate (T*K,) float32 by pair id; pairs
// (T*K,) int64, the pair ids sorted by expert, the dead tokens' last;
// offsets (E + 1,) int64; bucket (T*K,) and counts (blocks * (E + 1),)
// int32 workspaces, blocks = ceil(T / 32).  Returns cudaGetLastError()
// after the two launches.
extern "C" int moe_route_launch(const void* logits, int ld, const void* live,
                                int T, int E, int K, void* gate, void* pairs,
                                void* offsets, void* bucket, void* counts,
                                void* stream) {
  if (T < 1 || E < 1 || E > kMaxExperts || K < 1 || K > kMaxK || K > E ||
      ld < E)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (T + kRouteTokens - 1) / kRouteTokens;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  route_topk_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(logits), ld,
      static_cast<const unsigned char*>(live), T, E, K,
      static_cast<float*>(gate), static_cast<int*>(bucket),
      static_cast<int*>(counts));
  route_scatter_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int*>(bucket), static_cast<const int*>(counts), T, E,
      K, static_cast<int64_t*>(pairs), static_cast<int64_t*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// x (T, D) float32, row stride ldx; pairs / offsets as moe_route_launch
// gives them; wg, wi (E, D, F) and wo (E, F, D) float32 contiguous; gate
// (T*K,); h (P, F) float32 workspace; out (P, D) float32 zero-filled, P =
// T*K.  bm is the row tile (8, 32 or 64), m_tiles the grid's row tiles.  D and F are
// multiples of 4 and every base 16-byte aligned.
extern "C" int grouped_swiglu_launch(const void* x, long long ldx,
                                     const void* pairs, const void* offsets,
                                     const void* wg, const void* wi,
                                     const void* wo, const void* gate,
                                     void* h, void* out, int D, int F, int E,
                                     int K, int bm, int m_tiles,
                                     void* stream) {
  if (D < 4 || D % 4 || F < 4 || F % 4 || E < 1 || K < 1 || m_tiles < 1 ||
      ldx < D || ldx % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  const auto* pp = static_cast<const int64_t*>(pairs);
  const auto* op = static_cast<const int64_t*>(offsets);
  const auto* gp = static_cast<const float*>(wg);
  const auto* ip = static_cast<const float*>(wi);
  const auto* wp = static_cast<const float*>(wo);
  const auto* gt = static_cast<const float*>(gate);
  auto* hp = static_cast<float*>(h);
  auto* outp = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 8:
      return launch_grouped<8, 32, 2>(xp, ldx, pp, op, gp, ip, wp, gt, hp,
                                      outp, D, F, E, K, m_tiles, s);
    case 32:
      return launch_grouped<32, 16, 2>(xp, ldx, pp, op, gp, ip, wp, gt, hp,
                                       outp, D, F, E, K, m_tiles, s);
    case 64:
      return launch_grouped<64, 16, 4>(xp, ldx, pp, op, gp, ip, wp, gt, hp,
                                       outp, D, F, E, K, m_tiles, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
