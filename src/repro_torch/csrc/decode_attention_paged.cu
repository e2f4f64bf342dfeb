// paged decode attention — flash-decode GQA of one query token per slot over
// a paged KV pool, its keys split across SMs, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py,
//   decode_attention_paged_pallas (bodies _paged_kernel and, for int8
//   pools, _paged_kernel_quant), which share the online-softmax step
//   _flash_update.  The chunk case (C > 1 query tokens per slot,
//   decode_attention_chunk_paged_pallas) is chunk_paged_attention_kernel
//   in chunk_paged_attention.cu, with its own C entry point.
// The pool is (P, page, K, D); an int32 block table (B, n_pages) maps each
// slot's logical pages to physical ones; a (B, n_pages * page) byte mask
// says which key positions the query may see (position and sliding
// window).  Like the TPU kernels it keeps q in float32, upcasts K/V to
// float32, starts the running max at -1e30, gives masked keys probability 0
// and finishes with acc / max(l, 1e-30), so a query that sees no key
// returns 0.  An int8 pool comes with (P, K) float32 scales, one per
// physical page and kv head: a key's score is its dot with the int8 levels
// times scale_k, and a value row's weight is folded with scale_v (the TPU
// bodies' `k.astype(f32) * sk`, reassociated).
//
// What bounds it on the H100: HBM bytes, 2 * K * D * 2 bytes per visible
// position in bf16 (half that, plus 8 bytes of scales per page and kv head,
// in int8), against 4 * G * D float32 operations per position and kv head:
// at G <= 8 far under the ALU line.  In practice a decode call moves well
// under a megabyte, so what it costs is latency: launch, the dependent
// global round trips of a block, and the blocks in flight.
//
// What the design does about that:
//   * the keys are split across blocks: the grid is (kv head, slot,
//     split), each split a contiguous range of whole logical pages whose
//     length the host picks from B * K, n_pages and page alone (never from
//     the mask or the block table, which would need a copy to the host, so
//     the call stays capturable in a CUDA graph): 17 splits of 2 pages give
//     qwen2's L and S decode 136 blocks where one block per (kv head,
//     slot) gave 8;
//   * a block reads its split's block-table entries and mask bytes once, up
//     front (the mask as one bit per position, by warp ballots), then the
//     int8 scales of the pages some position of the split is seen in: one
//     dependent round trip before its rows' copies start.  Rows, pages and
//     scales no query sees are never loaded: page 0, unallocated pages and
//     stale tails may hold NaN;
//   * rows are staged with cp.async, 16 bytes a thread (8 for an int8 row
//     of D 120, 7.5 16-byte units), in two stages: the
//     next tile's copies are in flight while this tile is computed.  A row
//     no query sees is zero-filled by the copy itself (src-size 0, no read):
//     its weight is 0 by a select, and 0 * 0 stays 0;
//   * a tile is one online-softmax step for the group's G <= 8 query heads,
//     with the work flattened so that no lane computes a padding head: the
//     (head, key) scores one per thread over the staged row (rows padded to
//     an odd number of 16-byte units, so a quarter-warp's 16-byte reads of 8
//     rows hit 8 bank groups), then one warp per head for the tile's max,
//     weights and sum, then the (head, 4 columns) outputs one per thread
//     over the tile's rows.  No shuffle sits in the per-key path;
//   * the splits merge in a fixed order, so two calls give the same bits:
//     each block writes its partial (acc, m, l) to a float32 workspace the
//     wrapper allocates with torch.empty, and the last block of a (slot,
//     kv head) to finish (an atomic count on a counter the wrapper keeps
//     zeroed) merges all of them in split order, writes acc / max(l, 1e-30)
//     and resets the counter.  One launch a call; a single split writes its
//     result directly.  A split that sees nothing has m = -1e30, l = 0,
//     acc = 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 8;        // query heads per kv head
constexpr int kMaxSplits = 256;     // splits per (slot, kv head)
constexpr int kMaxSplitPos = 1024;  // positions per split
constexpr int kMaxSplitPages = 64;  // pages per split
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  // bytes per copy: 16, or 8 where a row is not whole 16-byte units (int8
  // at D 120: a 120-byte row is 15 copies of 8, none past the head's bytes)
  static constexpr int kCopy = D * (int)sizeof(T) % 16 == 0 ? 16 : 8;
  static constexpr int kVec = kCopy / (int)sizeof(T);  // elements per copy
  static constexpr int kVecPerRow = D / kVec;
  // keys per tile: about 8 KB per tile and operand, a multiple of 8
  static constexpr int kTileRaw = 8192 / (D * (int)sizeof(T));
  static constexpr int kTile = (kTileRaw < 64 ? kTileRaw : 64) / 8 * 8;
  // staged row stride: an odd number of copy units
  static constexpr int kLd = (kVecPerRow | 1) * kVec;
  static constexpr int kStage = kTile * kLd * (int)sizeof(T);  // bytes
  static constexpr int kCols = D / 4;                // 4-column output units
  static constexpr int kUnits = (kMaxGroup * kCols + kThreads - 1) / kThreads;
  static_assert(D % kVec == 0 && D % 8 == 0 && kStage % 16 == 0,
                "unsupported head dim");
  static_assert(kTile >= 8, "a tile holds at least 8 keys");
  static_assert(2 * 2 * kStage >= kMaxSplits * kMaxGroup * 4,
                "the merge's weights fit the stages");
};

// kBytes (16 or 8) from global to shared; src_size 0 reads nothing and
// zero-fills
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_size) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                    "l"(src), "r"(src_size) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                    "l"(src), "r"(src_size) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ bool bit(const uint32_t* w, int s) {
  return (w[s >> 5] >> (s & 31)) & 1u;
}

// whether any bit in [a, b) is set
__device__ __forceinline__ bool any_bit(const uint32_t* w, int a, int b) {
  for (int i = a; i < b;) {
    const int sh = i & 31;
    const int n = 32 - sh < b - i ? 32 - sh : b - i;
    const uint32_t m = (n == 32 ? 0xffffffffu : (1u << n) - 1u) << sh;
    if (w[i >> 5] & m) return true;
    i += n;
  }
  return false;
}

// kVec staged elements (16 bytes) as floats
__device__ __forceinline__ void unpack16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const int8_t* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
}

// 8 staged int8 elements (one 8-byte copy unit) as floats
__device__ __forceinline__ void unpack8(const int8_t* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {v.x, v.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
}

// 4 staged elements as floats
__device__ __forceinline__ void unpack4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void unpack4(const int8_t* p, float* f) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = static_cast<float>(static_cast<int8_t>(v >> (8 * j)));
}

// Grid (kv head, slot, split).  ws holds, per (slot, kv head, split),
// acc (G, D) then m (G) then l (G), float32, in G * (D + 4) floats (16-byte
// aligned partials), m in log2 units (the softmax runs on exp2); counters
// one int per (slot, kv head), 0 between calls.
// T = int8_t reads scale_k / scale_v; the other types get null pointers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
paged_attention_split_kernel(const float* __restrict__ q,
                             const T* __restrict__ pool_k,
                             const T* __restrict__ pool_v,
                             const float* __restrict__ scale_k,
                             const float* __restrict__ scale_v,
                             const int* __restrict__ block,
                             const uint8_t* __restrict__ valid,
                             float* __restrict__ ws, int* __restrict__ counters,
                             float* __restrict__ out, int kv_heads, int group,
                             int page, int n_pages, int split_pages,
                             float scale) {
  using C = Cfg<T, D>;
  constexpr int kTile = C::kTile, kLd = C::kLd, kVec = C::kVec;
  constexpr int kCols = C::kCols;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;

  // [stage][K | V][key][kLd]; after the loop the merge's weights
  __shared__ __align__(16) unsigned char kv_raw[2 * 2 * C::kStage];
  __shared__ __align__(16) float qs[kMaxGroup * D];
  __shared__ float ps[kMaxGroup][kTile];       // scores, then weights
  __shared__ uint32_t live_w[kMaxSplitPos / 32];
  __shared__ int blk_s[kMaxSplitPages];
  __shared__ float sk_s[kQuant ? kMaxSplitPages : 1];
  __shared__ float sv_s[kQuant ? kMaxSplitPages : 1];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], corr_s[kMaxGroup];
  __shared__ int last_s;

  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int heads = kv_heads * group;
  const int s_tot = n_pages * page;
  const int p0 = sp * split_pages;
  const int np = split_pages < n_pages - p0 ? split_pages : n_pages - p0;
  const int n_pos = np * page;                 // this split's positions
  const int64_t row_stride = static_cast<int64_t>(kv_heads) * D;

  // ---- up front: q (scaled into log2 units), the mask as bits, the pages
  const float* qb = q + (static_cast<int64_t>(b) * heads + kh * group) * D;
  for (int i = tid; i < group * D; i += kThreads)
    qs[i] = qb[i] * (scale * kLog2e);
  const uint8_t* vb = valid + static_cast<int64_t>(b) * s_tot + p0 * page;
  for (int i = tid; i < (n_pos + 31) / 32 * 32; i += kThreads) {  // whole warps
    const bool v = i < n_pos && vb[i];
    const uint32_t bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) live_w[i / 32] = bits;
  }
  if (tid < np) blk_s[tid] = block[static_cast<int64_t>(b) * n_pages + p0 + tid];
  if (tid < kMaxGroup) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if constexpr (kQuant) {
    // a page's scales only where some position of it is seen; used after
    // the first tile's barrier
    if (tid < np) {
      const bool seen = any_bit(live_w, tid * page, (tid + 1) * page);
      const int64_t si = static_cast<int64_t>(blk_s[tid]) * kv_heads + kh;
      sk_s[tid] = seen ? scale_k[si] : 0.f;
      sv_s[tid] = seen ? scale_v[si] : 0.f;
    }
  }

  // copies of tile t's rows into stage st; rows no query sees (and rows
  // past the split) are zero-filled without a read
  auto stage = [&](int t, int st) {
    T* kt = reinterpret_cast<T*>(kv_raw + (2 * st) * C::kStage);
    T* vt = reinterpret_cast<T*>(kv_raw + (2 * st + 1) * C::kStage);
    for (int i = tid; i < kTile * C::kVecPerRow; i += kThreads) {
      const int r = i / C::kVecPerRow, c = i % C::kVecPerRow;
      const int s = t * kTile + r;
      const bool live = s < n_pos && bit(live_w, s);
      int64_t off = 0;
      if (live)
        off = (static_cast<int64_t>(blk_s[s / page]) * page + s % page) *
                  row_stride + static_cast<int64_t>(kh) * D + c * kVec;
      cp_async<C::kCopy>(kt + r * kLd + c * kVec, pool_k + off,
                         live ? C::kCopy : 0);
      cp_async<C::kCopy>(vt + r * kLd + c * kVec, pool_v + off,
                         live ? C::kCopy : 0);
    }
    cp_async_commit();
  };

  float acc[C::kUnits][4];
#pragma unroll
  for (int u = 0; u < C::kUnits; ++u)
    acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;

  const int nt = (n_pos + kTile - 1) / kTile;
  stage(0, 0);
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt)
      stage(t + 1, st ^ 1);
    else
      cp_async_commit();                   // keep one group per tile
    cp_async_wait1();
    __syncthreads();
    const int t0 = t * kTile;
    const int tn = kTile < n_pos - t0 ? kTile : n_pos - t0;
    if (any_bit(live_w, t0, t0 + tn)) {    // uniform over the block
      const T* kt = reinterpret_cast<const T*>(kv_raw + (2 * st) * C::kStage);
      const T* vt =
          reinterpret_cast<const T*>(kv_raw + (2 * st + 1) * C::kStage);
      // scores: one (head, key) pair per thread; a key no query sees is
      // -1e30 by a select
      for (int i = tid; i < group * kTile; i += kThreads) {
        const int g = i / kTile, r = i % kTile;
        float sc = kNeg;
        if (r < tn && bit(live_w, t0 + r)) {
          const float* qg = qs + g * D;
          const T* kr = kt + r * kLd;
          float d0 = 0.f, d1 = 0.f;
#pragma unroll
          for (int c = 0; c < C::kVecPerRow; ++c) {
            float kf[kVec];
            if constexpr (C::kCopy == 16)
              unpack16(kr + c * kVec, kf);
            else
              unpack8(kr + c * kVec, kf);
#pragma unroll
            for (int e = 0; e < kVec; e += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qg + c * kVec + e);
              d0 = fmaf(qv.x, kf[e], d0);
              d1 = fmaf(qv.y, kf[e + 1], d1);
              d0 = fmaf(qv.z, kf[e + 2], d0);
              d1 = fmaf(qv.w, kf[e + 3], d1);
            }
          }
          sc = d0 + d1;
          if constexpr (kQuant) sc *= sk_s[(t0 + r) / page];
        }
        ps[g][r] = sc;
      }
      __syncthreads();
      // one warp per head: the tile's max, weights (scale_v folded in for
      // int8) and their sum, in a fixed shuffle tree
      if (warp < group) {
        const int g = warp;
        float mx = kNeg;
        for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, ps[g][r]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float psum = 0.f;
        for (int r = lane; r < kTile; r += 32) {
          const int s = t0 + r;
          const bool live = r < tn && bit(live_w, s);
          const float p = live ? exp2f(ps[g][r] - m_new) : 0.f;
          psum += p;
          float pv = p;
          if constexpr (kQuant) pv = live ? p * sv_s[s / page] : 0.f;
          ps[g][r] = pv;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, o);
        if (lane == 0) {
          const float corr = exp2f(m_old - m_new);
          corr_s[g] = corr;
          m_s[g] = m_new;
          l_s[g] = l_s[g] * corr + psum;
        }
      }
      __syncthreads();
      // outputs: one (head, 4 columns) unit per thread over the tile's rows
      // (zero rows weigh 0)
#pragma unroll
      for (int u = 0; u < C::kUnits; ++u) {
        const int unit = tid + u * kThreads;
        if (unit < group * kCols) {
          const int g = unit / kCols, d0 = (unit % kCols) * 4;
          const float corr = corr_s[g];
          float a0 = acc[u][0] * corr, a1 = acc[u][1] * corr;
          float a2 = acc[u][2] * corr, a3 = acc[u][3] * corr;
#pragma unroll 8
          for (int r = 0; r < kTile; ++r) {
            const float p = ps[g][r];
            float v[4];
            unpack4(vt + r * kLd + d0, v);
            a0 = fmaf(p, v[0], a0);
            a1 = fmaf(p, v[1], a1);
            a2 = fmaf(p, v[2], a2);
            a3 = fmaf(p, v[3], a3);
          }
          acc[u][0] = a0;
          acc[u][1] = a1;
          acc[u][2] = a2;
          acc[u][3] = a3;
        }
      }
    }
    __syncthreads();  // the stage is overwritten two tiles on
  }

  float* ob = out + (static_cast<int64_t>(b) * heads + kh * group) * D;
  if (n_split == 1) {
#pragma unroll
    for (int u = 0; u < C::kUnits; ++u) {
      const int unit = tid + u * kThreads;
      if (unit < group * kCols) {
        const int g = unit / kCols, d0 = (unit % kCols) * 4;
        const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
        *reinterpret_cast<float4*>(ob + g * D + d0) =
            make_float4(acc[u][0] * inv, acc[u][1] * inv, acc[u][2] * inv,
                        acc[u][3] * inv);
      }
    }
    return;
  }

  // ---- this split's partial, then the last block of (slot, kv head) merges
  const int stride = group * (D + 4);
  float* wsb = ws + (static_cast<int64_t>(b) * kv_heads + kh) * n_split *
                        stride;
  float* wb = wsb + sp * stride;
#pragma unroll
  for (int u = 0; u < C::kUnits; ++u) {
    const int unit = tid + u * kThreads;
    if (unit < group * kCols) {
      const int g = unit / kCols, d0 = (unit % kCols) * 4;
      *reinterpret_cast<float4*>(wb + g * D + d0) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
  }
  if (tid < group) {
    wb[group * D + tid] = m_s[tid];
    wb[group * D + group + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + b * kv_heads + kh;
  if (tid == 0) last_s = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // weights per (split, head): one warp per head, lanes over splits, the
  // max and the sum of l in fixed shuffle trees
  float* w = reinterpret_cast<float*>(kv_raw);   // [split][kMaxGroup]
  if (warp < group) {
    const int g = warp;
    float mx = kNeg;
    for (int s = lane; s < n_split; s += 32)
      mx = fmaxf(mx, __ldcg(wsb + s * stride + group * D + g));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lt = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float f = exp2f(__ldcg(wsb + s * stride + group * D + g) - mx);
      w[s * kMaxGroup + g] = f;
      lt += f * __ldcg(wsb + s * stride + group * D + group + g);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    if (lane == 0) l_s[g] = fmaxf(lt, 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < C::kUnits; ++u) {
    const int unit = tid + u * kThreads;
    if (unit < group * kCols) {
      const int g = unit / kCols, d0 = (unit % kCols) * 4;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int s = 0; s < n_split; ++s) {       // split order
        const float f = w[s * kMaxGroup + g];
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(wsb + s * stride + g * D +
                                                   d0));
        a0 = fmaf(f, v.x, a0);
        a1 = fmaf(f, v.y, a1);
        a2 = fmaf(f, v.z, a2);
        a3 = fmaf(f, v.w, a3);
      }
      const float inv = 1.f / l_s[g];
      *reinterpret_cast<float4*>(ob + g * D + d0) =
          make_float4(a0 * inv, a1 * inv, a2 * inv, a3 * inv);
    }
  }
  if (tid == 0) *counter = 0;              // ready for the next call
}

struct Args {
  const void *q, *k, *v, *sk, *sv, *block, *valid;
  void *ws, *counters, *out;
  int b, kv, group, page, n_pages, split_pages, n_split;
  float scale;
};

template <typename T, int D>
int launch(const Args& a, cudaStream_t st) {
  paged_attention_split_kernel<T, D>
      <<<dim3(a.kv, a.b, a.n_split), kThreads, 0, st>>>(
          static_cast<const float*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const float*>(a.sk),
          static_cast<const float*>(a.sv), static_cast<const int*>(a.block),
          static_cast<const uint8_t*>(a.valid), static_cast<float*>(a.ws),
          static_cast<int*>(a.counters), static_cast<float*>(a.out), a.kv,
          a.group, a.page, a.n_pages, a.split_pages, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const Args& a, cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 80: return launch<T, 80>(a, st);
    case 120: return launch<T, 120>(a, st);
    case 128: return launch<T, 128>(a, st);
    case 256: return launch<T, 256>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, C, H, D) float32; pool_k/v: (P, page, K, D) of `dtype` (0 =
// float32, 1 = bfloat16, 2 = int8); scale_k/v: (P, K) float32 for int8
// pools, null otherwise; block: (B, n_pages) int32; valid: (B, C,
// n_pages * page) bytes; out: (B, C, H, D) float32.  All contiguous;
// H = K * group, group <= 8; D in {32, 64, 80, 120, 128, 256}.  The keys split
// into ceil(n_pages / split_pages) ranges of split_pages pages (at most 64
// pages and 1,024 positions each, at most 256 ranges); with more than one,
// ws is a float32 workspace of B * K * n_split * group * (D + 4) and
// counters B * K ints, all 0 (the kernel leaves them 0).  The decode kernel
// is C = 1 (C > 1 is chunk_paged_attention_launch, chunk_paged_attention.cu).
// Another C, a bad split, an unknown dtype code, or scales that do not
// match the dtype, is cudaErrorInvalidValue and launches nothing.  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_launch(const void* q, const void* pool_k,
                                      const void* pool_v, const void* scale_k,
                                      const void* scale_v, const void* block,
                                      const void* valid, void* ws,
                                      void* counters, void* out, int dtype,
                                      int b, int c, int kv, int group, int d,
                                      int page, int n_pages, int split_pages,
                                      float scale, void* stream) {
  if (b < 1 || c != 1 || kv < 1 || group < 1 || group > kMaxGroup ||
      page < 1 || n_pages < 1 || split_pages < 1 ||
      split_pages > kMaxSplitPages || split_pages * page > kMaxSplitPos ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = (n_pages + split_pages - 1) / split_pages;
  if (n_split > kMaxSplits ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool has_scales = scale_k != nullptr && scale_v != nullptr;
  const bool no_scales = scale_k == nullptr && scale_v == nullptr;
  const Args a{q, pool_k, pool_v, scale_k, scale_v, block, valid, ws,
               counters, out, b, kv, group, page, n_pages, split_pages,
               n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (!no_scales) break;
      return dispatch_d<float>(d, a, st);
    case 1:
      if (!no_scales) break;
      return dispatch_d<__nv_bfloat16>(d, a, st);
    case 2:
      if (!has_scales) break;
      return dispatch_d<int8_t>(d, a, st);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
