// paged decode attention — flash-decode GQA of one query token per slot over
// a paged KV pool, for Hopper (sm_90a).
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
// returns 0.
// An int8 pool comes with (P, K) float32 scales, one per physical page and
// kv head: a staged key row is dequantised in registers, float(int8) *
// scale[block[b, j], kv], before the same float32 online-softmax step (the
// TPU bodies' `k.astype(f32) * sk`).  The scale is read once per staged
// row, and only for rows the query sees: a stale or unallocated page's
// scale may hold anything.
//
// What bounds it on the H100: HBM bytes.  Each slot's visible K/V rows are
// read once, 2 * K * D * 2 bytes per position in bf16 (half that, plus 8
// bytes of scales per page and kv head, in int8), against 4 * G * D float32
// operations per position and kv head: at G <= 6 well under the ALU line.
//
// What the design does about that:
//   * one block per (kv head, slot, 8 query heads of its group): the
//     group's heads share every K/V byte the block reads;
//   * the block table is read from global memory by the block itself (the
//     TPU scalar-prefetches it), once per key row of a tile;
//   * key tiles of up to 64 positions are staged in shared memory with
//     16-byte loads; the mask is staged per tile, and tiles, and rows inside
//     a tile, that the query may not see are never loaded: page 0,
//     unallocated pages and stale page tails may hold anything;
//   * each warp owns key rows of the tile and keeps an online-softmax state
//     for the query rows in registers (lanes split D); the dot products of
//     a key row reduce in interleaved shuffles; a key a query row may not
//     see is skipped for that row (a select, never a multiply by 0); the
//     warps' states merge once, in a fixed order, at the end.
// With B * K blocks the grid fills few of the 132 SMs: splitting the keys
// across blocks, as decode_attention.cu does for the drain path, is the
// next change here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;          // query rows per block
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// T = int8_t reads scale_k / scale_v; the other types get null pointers and
// compile without the scale code.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const float* __restrict__ scale_k,
                       const float* __restrict__ scale_v,
                       const int* __restrict__ block,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, int c_len, int kv_heads,
                       int group, int page, int n_pages, float scale) {
  // lane l owns elements [l * kEpl, l * kEpl + kEpl) below D; where D is
  // not a multiple of 32 (80) the last lanes own fewer or none: they load
  // nothing and add 0 to every dot product
  constexpr int kEpl = (D + 31) / 32;            // elements per lane
  constexpr int kTileCap = 16384 / (D * (int)sizeof(T));
  constexpr int kTile = kTileCap < 64 ? kTileCap : 64;
  constexpr int kVec = 16 / (int)sizeof(T);      // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static_assert(D % 16 == 0 && D % kVec == 0, "unsupported head dim");

  __shared__ __align__(16) unsigned char k_raw[kTile * D * sizeof(T)];
  __shared__ __align__(16) unsigned char v_raw[kTile * D * sizeof(T)];
  T* k_tile = reinterpret_cast<T*>(k_raw);
  T* v_tile = reinterpret_cast<T*>(v_raw);
  __shared__ uint8_t m_tile[kRows][kTile];   // query row may see key row
  __shared__ uint8_t live[kTile];            // some query row sees it
  __shared__ int64_t row_off[kTile];         // the key row's element offset
  __shared__ float row_sk[kQuant ? kTile : 1];  // its page's scales (int8)
  __shared__ float row_sv[kQuant ? kTile : 1];
  __shared__ float acc_sum[kRows * D];
  __shared__ float m_part[kWarps][kRows];
  __shared__ float l_part[kWarps][kRows];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int e0 = lane * kEpl;
  const int n_q = c_len * group;             // query rows of (slot, kv head)
  const int heads = kv_heads * group;
  const int s_tot = n_pages * page;

  // query row r -> (chunk token c = r / group, head kh * group + r % group)
  float qr[kRows][kEpl];
  float acc[kRows][kEpl];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    m[i] = kNeg;
    l[i] = 0.f;
    const float* qp = q;
    if (r < n_q)
      qp += ((static_cast<int64_t>(b) * c_len + r / group) * heads +
             kh * group + r % group) * D;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      qr[i][e] = (r < n_q && e0 + e < D) ? qp[e0 + e] : 0.f;
      acc[i][e] = 0.f;
    }
  }

  const int* blk = block + static_cast<int64_t>(b) * n_pages;
  const uint8_t* vb = valid + static_cast<int64_t>(b) * c_len * s_tot;
  const int64_t row_stride = static_cast<int64_t>(kv_heads) * D;

  for (int s0 = 0; s0 < s_tot; s0 += kTile) {
    for (int i = tid; i < kRows * kTile; i += kThreads) {
      const int qi = i / kTile, r = i % kTile;
      const int rq = r0 + qi, s = s0 + r;
      m_tile[qi][r] = (rq < n_q && s < s_tot)
                          ? vb[static_cast<int64_t>(rq / group) * s_tot + s]
                          : 0;
    }
    __syncthreads();
    int any = 0;
    if (tid < kTile) {
      uint8_t f = 0;
#pragma unroll
      for (int qi = 0; qi < kRows; ++qi) f |= m_tile[qi][tid];
      live[tid] = f;
      any = f;
      if (f) {
        const int s = s0 + tid;
        const int64_t phys = blk[s / page];
        row_off[tid] = (phys * page + s % page) * row_stride +
                       static_cast<int64_t>(kh) * D;
        if constexpr (kQuant) {
          row_sk[tid] = scale_k[phys * kv_heads + kh];
          row_sv[tid] = scale_v[phys * kv_heads + kh];
        }
      }
    }
    if (!__syncthreads_or(any)) continue;   // no query row sees this tile

    for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow, c = i % kVecPerRow;
      if (!live[r]) continue;
      const int64_t off = row_off[r] + c * kVec;
      reinterpret_cast<int4*>(k_tile)[i] =
          *reinterpret_cast<const int4*>(pool_k + off);
      reinterpret_cast<int4*>(v_tile)[i] =
          *reinterpret_cast<const int4*>(pool_v + off);
    }
    __syncthreads();

    for (int r = warp; r < kTile; r += kWarps) {
      if (!live[r]) continue;
      float kf[kEpl], vf[kEpl];
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        const bool in = e0 + e < D;
        kf[e] = in ? to_float(k_tile[r * D + e0 + e]) : 0.f;
        vf[e] = in ? to_float(v_tile[r * D + e0 + e]) : 0.f;
        if constexpr (kQuant) {
          kf[e] *= row_sk[r];
          vf[e] *= row_sv[r];
        }
      }
      float dot[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        dot[i] = 0.f;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) dot[i] = fmaf(qr[i][e], kf[e], dot[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (!m_tile[i][r]) continue;         // warp-uniform: skip, never * 0
        const float score = dot[i] * scale;
        const float m_new = fmaxf(m[i], score);
        const float corr = expf(m[i] - m_new);
        const float p = expf(score - m_new);
        m[i] = m_new;
        l[i] = l[i] * corr + p;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) acc[i][e] = acc[i][e] * corr + p * vf[e];
      }
    }
    __syncthreads();  // the tiles are overwritten next iteration
  }

  // Merge the warps' online-softmax states, in a fixed order.
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      m_part[warp][i] = m[i];
      l_part[warp][i] = l[i];
    }
  }
  for (int i = tid; i < kRows * D; i += kThreads) acc_sum[i] = 0.f;
  __syncthreads();
  float m_all[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_all[i] = kNeg;
    for (int w = 0; w < kWarps; ++w) m_all[i] = fmaxf(m_all[i], m_part[w][i]);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float f = expf(m[i] - m_all[i]);
#pragma unroll
        for (int e = 0; e < kEpl; ++e)
          if (e0 + e < D) acc_sum[i * D + e0 + e] += acc[i][e] * f;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int qi = i / D, e = i % D;
    const int r = r0 + qi;
    if (r >= n_q) continue;
    float lt = 0.f, mx = kNeg;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_part[w][qi]);
    for (int w = 0; w < kWarps; ++w)
      lt += l_part[w][qi] * expf(m_part[w][qi] - mx);
    out[((static_cast<int64_t>(b) * c_len + r / group) * heads + kh * group +
         r % group) * D + e] = acc_sum[i] / fmaxf(lt, 1e-30f);
  }
}

struct Args {
  const void *q, *k, *v, *sk, *sv, *block, *valid;
  void* out;
  int b, c, kv, group, page, n_pages;
  float scale;
};

template <typename T, int D>
int launch(const Args& a, cudaStream_t st) {
  const int tiles = (a.c * a.group + kRows - 1) / kRows;
  paged_attention_kernel<T, D><<<dim3(a.kv, a.b, tiles), kThreads, 0, st>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.sk),
      static_cast<const float*>(a.sv), static_cast<const int*>(a.block),
      static_cast<const uint8_t*>(a.valid), static_cast<float*>(a.out), a.c,
      a.kv, a.group, a.page, a.n_pages, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const Args& a, cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 80: return launch<T, 80>(a, st);
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
// H = K * group; D in {32, 64, 80, 128, 256}.  The decode kernel is C = 1
// (C > 1 is chunk_paged_attention_launch, chunk_paged_attention.cu).
// Another C, an unknown dtype code, or scales that do not match the dtype,
// is cudaErrorInvalidValue and launches nothing.  Returns cudaGetLastError()
// after the launch.
extern "C" int paged_attention_launch(const void* q, const void* pool_k,
                                      const void* pool_v, const void* scale_k,
                                      const void* scale_v, const void* block,
                                      const void* valid, void* out, int dtype,
                                      int b, int c, int kv, int group, int d,
                                      int page, int n_pages, float scale,
                                      void* stream) {
  if (b < 1 || c != 1 || kv < 1 || group < 1 || page < 1 || n_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool has_scales = scale_k != nullptr && scale_v != nullptr;
  const bool no_scales = scale_k == nullptr && scale_v == nullptr;
  const Args a{q, pool_k, pool_v, scale_k, scale_v, block, valid, out,
               b, c, kv, group, page, n_pages, scale};
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
